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
   15 distinct (M, K, N) of ResNet-50's 36 1x1 convolutions at batch 32,
   [21]'s dense shapes (LeNet's 2450 -> 500 at M 64 and 256, SimpleCNN's
   9216 -> 128 at M 32, and M 37) plus two ragged shapes, float32 and
   bfloat16, activations identity, relu and gelu;
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
   (the FFMA kernel); the suffix prefill of the prefix cache: 8 rows x Tq
   16/32/64/128 against Tk = 512 or 1024 + Tq keys with a holed key mask
   (each row's prefix valid to its length, padding, its suffix) and a
   group-padding row; float32 and bfloat16; o, l and m, every row finite,
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
   then, on the same model, [19] and [20] (below);
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
   int8 stock route and the float32 AlexNet, in turns;
19. the prefix cache on [11]'s model: ``GenerationEngine`` with
   ``prefix_cache=True, prefix_page=16, prefix_cache_pages=256``; a cold
   sweep (16 greedy requests: one seeded 512-token shared prefix and
   distinct 16-128-token tails, 32 new tokens each), then a hot sweep (8
   follow-up turns extending cold prompts and 8 new tails of the shared
   prefix); at least 16 hot-sweep hits and no pin left after close; the
   kernels' launches counted over the hot sweep alone (12 flash per
   prefill or suffix prefill, 12 paged per decode step), flash launches
   printed by (Tq, Tk); every stream held against sequential ``generate``
   and against the same engine with ``use_kernels=False`` (near-tie rule);
   TTFT p50/p95 cold against hot, pages held; the flash kernel at the hot
   sweep's suffix geometries beside its plain version, SDPA and the bound;
20. speculative decoding on [11]'s model, ``spec_tokens=4``, with an oracle
   draft (the target's configuration and seed) and a DistilGPT2-width
   draft (6 layers, 768 wide, 12 heads, seeded):
   [11]'s 16 prompts, one decoding to the 1024 context edge (the fallback
   window), two sampled requests (temperature 0.8, fixed seeds); launches
   counted per run (the draft's prefills and decode steps through the
   kernels); greedy streams held against sequential ``generate`` (near-tie
   rule), sampled streams against the sequential sampler with the same
   seed; the oracle's acceptance above 0 (the seeded draft's reported:
   random LMs of unrelated weights rarely agree); the decode kernel at the
   draft windows' KV buckets; tokens/s against the plain engine in turns;
   then both features at once over [19]'s sweeps, streams held;
21. MultiLayerNetwork training: LeNet (28x28x1, 1,256,080 params, the
   zoo's configuration with Adam(2e-3)) trained by ``fit`` on the seeded
   synthetic MNIST set (8192 examples, batch 64, 2 epochs: 256 steps) and
   evaluated on 2048 test examples at batch 256, ``use_kernels=True``
   against ``use_kernels=False`` from the same seed (cuDNN's deterministic
   algorithms, so each route's trajectory is the same from call to call):
   the first 10 step
   scores agree, both reach test accuracy 0.85 within 2 points of each
   other, and ``matmul_bias_act`` launches exactly once per step and
   evaluation batch over the kernel route's fit and evaluate; the trained
   net written as the ModelSerializer zip and restored on the card (params,
   updater state, counters and output bit for bit with cuDNN's
   deterministic algorithms) and 5 more steps on both from the same
   batches, params bit for bit; step time and examples/s per route in
   turns, device time and idle share of 20 steps under ``torch.profiler``;
   SimpleCNN (48x48x3, batch 32) 5 steps kernel route against stock
   (step-1 gradients, scores, BN state), then its BN-folded serving copy
   against ``fold_bn=False``; row 1 timed at the dense shapes beside its
   plain version, ``F.linear`` + relu and the bound;
22. bf16-policy training of ResNet-50: first the s2d stem (float32, eval,
   ``use_kernels=False``) with weights from ``stem_weights_to_s2d`` against
   the 7x7 stem; then full-width ResNet-50 with ``stem_space_to_depth`` and
   ``fused_conv_bn`` under ``compute_dtype="bfloat16"`` (batch 32, seeded
   weights and one-hot labels, Adam(1e-3)) trained 18 steps by
   ``ComputationGraph.fit`` on the kernel route with a
   ``CheckpointListener`` saving every 5 iterations and keeping 2:
   ``matmul_stats`` launches 36 times a step in bf16 over the fit alone,
   the loss falls, params, updater state and BN state stay float32;
   retention keeps the zips of iterations 10 and 15, and the newest zip,
   restored by ``load_checkpoint_graph`` and trained the remaining 3
   steps, equals the uninterrupted run bit for bit (cuDNN's deterministic
   algorithms for both); the kernel route against the bf16 stock route,
   both against the float32 stock route (``BF16_*_FLOOR``): step-1
   gradients, 3 losses, BN state; the bf16 step per route beside [7]'s
   float32 step per route in turns, device time and idle share; row 2 in
   bf16 at the 36 sites beside its plain version, ``F.linear``, the stock
   composite and the bf16 bound;
23. the GPT-2-small-width LM under the bf16 policy trained by ``fit`` on
   [14]'s batch: 12 flash, 12 dq and 12 dk/dv launches a step in bf16,
   the loss falls over 5 steps and tracks [14]'s float32 losses, step-1
   gradients and 3 losses against the stock routes as in [22]; the bf16
   step per route beside the float32 step per route; rows 6-8 in bf16 at
   [8, 12, 1024, 64] causal beside their plain versions, SDPA's forward
   and backward in bf16 and the bf16 bound;
24. a graph with one causal ``AttentionVertex`` (12 heads x 64, width 768,
   a ragged key mask as a network input) over 8 x 1024, 2 steps in float32
   and 2 in bf16, each against ``use_kernels=False``; rows 6-8 launch once
   a forward and backward.

25. the kernel registry and the per-shape tuner, last (every phase above
   runs each kernel at its default tiling): the envelopes
   ``plan_envelopes`` gives ResNet-50 served at batch 32 (the 1x1 sites,
   ``matmul_bias_act``), the fused ResNet-50 train step at batch 32 in
   float32 and bf16 (``conv_bn_act``) and the int8 AlexNet at batch 32,
   and those ``decoder_envelopes`` gives [11]'s LM (``paged_decode_attention``
   per KV bucket, ``flash_attention`` per prompt and join bucket); every
   candidate tiling of each against the plain version (the default among
   them) and against the default's bits; ``autotune_model`` for the three
   ResNet-50 / AlexNet confs and ``GenerationEngine.warmup(autotune_kernels=
   True)`` for the LM, each envelope's candidates, default, winner and
   times logged; then a served batch of ResNet-50 and of the int8 AlexNet
   against the stock route, one train step's loss per dtype, and [11]'s
   greedy requests against sequential ``generate`` and the stock route;
   every planned envelope resolves a tuned winner
   (``dl4j_kernel_selected_total``) and no routed envelope is unplanned; the
   tag changes; the cache saved and bound fresh (same digests), then
   corrupted: ``TuningCacheCorruptError`` names the file and the routes run
   the default tilings' bits; forward ms, tokens/s and decode step ms at
   the default tilings and tuned, and the tuner's seconds, for the record.
26. data-parallel training (``chip_data_parallel.py``): full-width
   ResNet-50 ``fused_conv_bn`` with ``use_kernels``, Adam(1e-3), global
   batch 32, through ``ParallelWrapper.fit`` in ranks of their own
   (``parallel.launch.spawn``). [26a] NCCL at the card count: exact and
   bucketed exact (25 MB) against ``ComputationGraph.fit`` on the same
   batches, every step (same bits expected at one rank), at [7]'s gates;
   [26b] two gloo ranks sharing ``cuda:0``, 16 rows each: exact against
   ``fit`` at batch 32 and its planted control (per-rank BN statistics
   must fail the gates), bucketed 25 / 0 MB the same bits, ZeRO the
   bucketed bits with the gathered Adam state and a mid-fit
   ``CheckpointListener`` zip restored to it, threshold (fixed, adaptive)
   kernel against stock by flipped messages, averaging every 2 steps
   (replicas the same bits after each average), kernel against stock in
   each mode; 36 ``matmul_stats`` launches per rank per step; step ms,
   exchange bytes, collective ms, peak memory and host-staged collectives
   reported.

27. the recurrent path (``chip_sequence.py``): the zoo's
   ``TextGenerationLSTM`` at full width (47 characters, LSTM(256) x 2,
   seeded) trained by ``fit_batch`` with truncated BPTT 50/50 on a seeded
   order-2 Markov character stream (batch 32, T 200): the card against
   the port's CPU run (forward, every segment's loss, params and Adam
   state), one-segment tBPTT against STANDARD, back 25 < fwd 50 at T 230
   against the CPU, a planted control (carries zeroed every segment) that
   must miss the gates, 200 greedy ``rnn_time_step`` steps after a
   40-character prime against one ``output`` and a mid-stream get / clear
   / set of the state resuming bit for bit; segment ms, launches, idle
   share, characters/s, peak memory;
28. sequence attention on rows 6-8 (``chip_sequence.py``; the kernel
   checks at ``SEQ_ATTN_CASES`` run in [9] and [13]): LSTM(256) +
   ``LearnedSelfAttentionLayer(attention_impl="flash")`` + RnnOutputLayer
   over 32 x 512 masked steps, 3 steps against the reference core (one
   launch of each kernel a step, one forward an ``output``),
   ``RecurrentAttentionLayer`` card against CPU, and rows 6-8 timed at
   the layer's geometry.
29. the multi-tenant serving platform (``chip_platform.py``): a
   ``ModelRegistry`` with full-width ResNet-50 v1 / v2 and AlexNet float32
   v1 / int8 v2, loaded back digest-verified, a tampered zip refused; a
   ``ModelPlatform`` with ``resnet`` (row 1), ``alexnet`` and the
   GPT-2-small-width ``lm`` (``deploy_generation``: rows 5-6) behind
   ``InferenceServer(platform)``, each answer held against the stock
   route and each stream against sequential ``generate``; a hot swap under
   traffic with no mixed launch; two seeded canary-chaos runs rolling back
   at one request index, co-tenants pinned; the int8 canary rolled back
   with a spoiled calibration and held, then promoted, with the real one
   (row 4); ``ParallelInference`` over the card. Per tenant p50 latency and
   images/s or tokens/s, swap and rollback times, load seconds a version.
30. the rest of the graph zoo (``chip_zoo.py``): VGG16, VGG19, SqueezeNet,
   Darknet19, UNet, Xception, InceptionResNetV1, TinyYOLO, YOLO2 and
   NASNet at their zoo defaults, float32, batch 8, seeded: the kernel
   route against ``use_kernels=False`` (the logits' relative L2 within
   the model's ``chip_zoo.LOGIT_REL_L2``, and row 1 with one TF32 product
   a term outside it; ``matmul_bias_act`` launches a forward, at each
   shape, equal to the sites ``routed_sites`` counts: 2, 2, 17, 7, 1, 4,
   71, 1, 8, 28 in all; the output shape the configuration's), forward
   ms, images/s and peak
   memory a route; YOLO2 behind ``InferenceServer`` (8 one-image requests
   against the stock route, the same detections after ``nms`` at the
   stock route's 99th-percentile score, p50 latency); row 1 at VGG's
   ``fc1`` / ``fc2``, SqueezeNet's ``conv10`` and InceptionResNetV1's and
   YOLO2's largest 1x1 sites beside its plain version, ``F.linear`` + the
   activation and the bounds.
31. the rest of the layer DSL (``chip_layers.py``): every
   ``conf/layers_extra.py`` layer on the card against the port on the
   CPU (forward and gradients) at its full sizes; MobileNet-v1 (224x224x3,
   width 1.0, batch 8) served on both routes (13 pointwise convs on row 1,
   logits within ``chip_layers.MOBILENET_REL_L2`` and a one-TF32-product
   control outside it); C3D (16x112x112x3 clips, 487 classes, batch 8)
   trained 3 SGD steps on both routes (fc6 / fc7 on row 1, two launches a
   step); row 1 at fc6, fc7 and MobileNet's first and last pointwise
   convs beside ``F.linear`` + the activation and the bounds.
32. the MoE transformer (``chip_moe.py``): the GPT-2-small-width LM with
   8 experts, top-2, capacity 1.25, trained 3 Adam steps at 8 x 1024 on
   both routes (rows 6-8 12 times a step; routing flips between the
   routes counted and gated, the other tokens' logits held); its experts
   across two gloo ranks on the card at 2 layers against one-rank
   ``fit_batch``, and NCCL at one rank the same bits.
33. fine-tuning a pretrained model under the health layer
   (``chip_transfer.py``): full-width AlexNet published with
   ``save_pretrained`` and restored with ``init_pretrained`` bit for bit
   (a flipped byte refused), a 7x7-stem ResNet-50 through
   ``restore_partial`` into the s2d stem; AlexNet fine-tuned through
   ``TransferLearning.Builder`` (frozen through pool5, a 10-class head,
   Adam 1e-4) under ``EarlyStoppingTrainer`` on a seeded template set
   (row 1 at fc6 / fc7, twice a step and an evaluation forward; the
   frozen convs unchanged; held-out logits a epoch against the stock
   route and a one-TF32-product control; best accuracy above 0.5);
   ``TransferLearningHelper`` against the full network; SKIP_STEP, WARN,
   ROLLBACK and HALT on a planted NaN batch (bit-identical skip, no added
   synchronization, exact rollback, a strict-JSON bundle, early stopping
   on the planted step); step, guard, snapshot and featurize times, row 1
   at fc6 / fc7.
34. preemption-safe, monitored training (``chip_session.py``): rows 1, 2
   and 6-8 on NaN (0x7fffffff, 0xffffffff), +-inf, 3.4e38 and FLT_MAX
   inputs keep their plain versions' NaN and inf pattern; full-width
   ResNet-50 (fused_conv_bn, Adam, batch 32, row 2 36 times a step)
   under ``TrainingSession(ParallelWrapper exact)`` at one NCCL rank,
   killed at ``train.step`` call 5 and resumed bit for bit, then resumed
   by a fresh process from the directory alone; ZeRO across two gloo
   ranks on the card with pod snapshots, host 1 dead at a heartbeat and
   resumed bit for bit, a 2 -> 1 restore and a corrupted shard passed
   over; SKIP_STEP / WARN across ranks in exact and ZeRO mode (no
   synchronizing call a step at NCCL); ``StatsListener`` posting to a
   ``UIServer`` whose endpoints answer; the legacy solvers on LeNet
   (row 1) on both routes; the profiler's NaN panic, step times, trace.

Then the ``{"session": ...}``, ``{"transfer": ...}``, ``{"layers": ...}``, ``{"moe": ...}``, ``{"zoo": ...}``, ``{"platform": ...}``, ``{"trained_text_lstm": ...}``,
``{"sequence_attention": ...}``, ``{"trained_mln": ...}`` and
``{"trained_bf16": ...}`` lines, one
``{"kernels": [...]}`` line with every kernel (row 1 with its [21] shapes
and launches; rows 2 and 6-8 with their bf16 numbers under
``bf16_training``; rows 1, 2, 4, 5, 6 with [25]'s numbers under
``tuning``; row 2 with [26]'s under ``data_parallel``; rows 6-8 with
[28]'s under ``seq_attention``; rows 1, 4, 5, 6 with [29]'s launches
under ``platform``; row 1 with [30]'s launches and shapes under ``zoo``
and [31]'s under ``layers`` and [33]'s under ``transfer``; rows 6-8 with
[32]'s launches under ``moe``),
the served,
trained, generated, trained_lm, served_int8, prefix_cached, speculative,
tuned and data_parallel lines, and last
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
import os
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
# [9] / [19] suffix prefill against cached prefix pages: Tq = ts suffix
# tokens against Tk = tpre + ts keys, tpre the prefix bucket
SUFFIX_BUCKETS = (16, 32, 64, 128)
SUFFIX_PREFIX_BUCKETS = (512, 1024)
# [19] the prefix cache: one seeded shared prefix (a system prompt) and
# seeded tails; the hot sweep's follow-up turns extend cold prompts
PREFIX_LEN = 512
PREFIX_TAIL = (16, 128)
PREFIX_FOLLOW_UP = (8, 48)
PREFIX_CONFIG = dict(prefix_cache=True, prefix_page=16,
                     prefix_cache_pages=256)
PREFIX_SEED = 5
# [20] speculative decoding: K drafted tokens a window; the drafts: the
# target's own configuration and seed (an oracle), and DistilGPT2's
# published widths (huggingface.co/distilbert/distilgpt2 config.json:
# n_layer 6, n_embd 768, n_head 12, vocab 50257, n_positions 1024),
# seeded: two random LMs of unrelated weights agree on about one token in
# 50257, so its acceptance is reported and only the oracle's must be > 0
DRAFT_SEED = 1
SPEC_TOKENS = 4
DRAFT_MODEL = dict(vocab_size=50257, embed_dim=768, n_heads=12, n_layers=6,
                   max_len=1024)
SPEC_SAMPLED = ((0.8, 17), (0.8, 29))  # (temperature, seed)
SPEC_SAMPLED_NEW = 24
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


# [22]-[24] the bf16 policy (compute_dtype="bfloat16": forward and backward
# in bfloat16; params, updater state, BN state, the loss and the outputs in
# float32). The kernel route is held against the bf16 stock route
# (use_kernels=False: cuDNN, cuBLAS and the materialized attention, in
# bf16) AND against the float32 stock route on the same weights and batch.
# A bf16 step is not close to a float32 step in a deep network: each layer
# output is rounded to 2**-8 relative, and train-mode BN in a random
# ResNet-50 amplifies such differences (the float32 routes needed
# condition_residual_bn to agree at 1e-3; in bf16 the kernel and stock
# routes' step-1 gradients part by 12-30% relative L2 in CPU trials at
# 32-64 px, each 20-50% from float32's). So the accuracy a bf16 step can
# have is measured in the same run, by the library's bf16 route against
# float32, and the kernel route must match it. Its step-1 gradient:
# - vs float32: relative L2 distance at most 1.5x the stock route's plus 4
#   bf16 ulps over the whole gradient, at most 2x plus 4 ulps per tensor;
# - vs the stock route: at most the stock route's own distance from
#   float32 plus 4 ulps over the whole gradient, 1.5x plus 4 ulps per
#   tensor. The two bf16 routes share their inputs' roundings, so they lie
#   closer to each other than either to float32 (on an H100 80GB HBM3 at
#   700 W: ResNet-50 5.8e-2 against 1.03e-1, the LM 1.05e-2 against
#   1.65e-2).
# The rule's own control: each tensor's kernel-route gradient in turn
# scaled by BF16_FAULT_SCALE (a wrong layer gradient) must break it, for
# tensors that hold at least BF16_FAULT_CAUGHT of the float32 gradient's
# squared norm. On the H100: every tensor of the LM and of the
# AttentionVertex graph; in ResNet-50, 34 of 161 tensors holding 0.87 of
# the norm, since the bf16 noise of the others (the stock route's distance
# from float32: median 0.26, up to 0.60 in the early stages' BN shifts and
# scales) hides a 30% error. Its later losses no further from float32's
# than 2x the stock route's plus 4 ulps; its BN running statistics after
# step 1 (float32 sums of bf16 y) no further from float32's than 2x the
# stock route's plus 4 ulps of their largest magnitude. The step-1 loss (a
# float32 head over bf16 features whose roundings average out) is held to
# the stock route's within one ulp.
BF16_ULP = 2.0 ** -8
BF16_GRAD_FLOOR = {"global": (1.5, 4 * BF16_ULP),
                   "tensor": (2.0, 4 * BF16_ULP)}
BF16_ROUTE_FLOOR = {"global": (1.0, 4 * BF16_ULP),
                    "tensor": (1.5, 4 * BF16_ULP)}
BF16_FAULT_SCALE = 1.3
BF16_FAULT_CAUGHT = 0.8
BF16_LOSS_FLOOR = (2.0, 4 * BF16_ULP)
BF16_STATE_FLOOR = (2.0, 4 * BF16_ULP)
BF16_LOSS_RTOL = BF16_ULP
# the bf16 LM's losses against [14]'s float32 losses on the same weights and
# batch, step by step, over LM_TRAIN_STEPS steps: 1e-2 relative (on an H100
# 80GB HBM3 at 700 W the runs part by at most 3e-4; a loss near ln(50257)
# that leaves the float32 run by 1% has left its trajectory)
BF16_TRACK_RTOL = 1e-2
# [22] the kernel route's uninterrupted run under a CheckpointListener that
# saves every CKPT_EVERY iterations and keeps the last CKPT_KEEP zips: saves
# at steps 5, 10 and 15, retention removes the first, and the run resumed
# from the newest zip trains the remaining 3 steps
BF16_STEPS = 18
CKPT_EVERY = 5
CKPT_KEEP = 2
# [22] the s2d stem against the 7x7 stem, float32, eval mode
S2D_BATCH = 4
# [24] the AttentionVertex graph's time-distributed softmax head
ATTN_VERTEX_CLASSES = 16


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

# [21] MultiLayerNetwork training. LeNet (the zoo's reference topology,
# 28x28x1, 1,256,080 params) on the seeded synthetic MNIST: 8192 training
# examples at batch 64 for 2 epochs (256 steps), 2048 test examples at
# batch 256; Adam(2e-3) as tests/test_mnist_e2e.py trains it, whose
# accuracy bar (0.85) both routes must reach, within 2 points of each
# other. The first 10 step scores of the two routes are held to
# TRAIN_LOSS_RTOL (the dense layer's 3xTF32 sums against cuBLAS's f32
# sums, then Adam's sign-like first steps).
LENET_TRAIN = dict(batch=64, num_examples=8192, seed=123)
LENET_TEST = dict(batch=256, num_examples=2048)
LENET_LR = 2e-3
LENET_EPOCHS = 2
LENET_COMPARE = 10
LENET_MIN_ACC = 0.85
LENET_ACC_GAP = 0.02
LENET_PROFILE_STEPS = 20
LENET_RESUME_STEPS = 5
# SimpleCNN (48x48x3, three 3x3 conv + BN blocks, dense 128): 5 steps at
# batch 32 on a seeded synthetic batch, kernel route against stock
SIMPLECNN_BATCH = 32
SIMPLECNN_STEPS = 5
SIMPLECNN_SEED = 21
# row 1 at [21]'s dense shapes (M, K, N): LeNet's 2450 -> 500 in training
# (M 64) and evaluation (M 256), SimpleCNN's 9216 -> 128 (M 32), and a
# ragged M; K = 2450 is no multiple of the kernel's 32-wide K step and
# N = 500 no multiple of its 64-wide tile
MLN_SHAPES = ((64, 2450, 500), (256, 2450, 500), (32, 9216, 128),
              (37, 2450, 500))


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counts() -> dict:
    """Launches of the serving kernels' wrappers since the last reset."""
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.ops import attention as att

    return {"matmul_bias_act": impls.matmul_bias_act.launches,
            "matmul_bias_act_int8": impls.matmul_bias_act_int8.launches,
            "flash_attention": att.flash_attention.launches,
            "paged_decode_attention": att.paged_decode_attention.launches}


def reset_launch_counts() -> None:
    """Every count of ``launch_counts`` and ``matmul_bias_act``'s tally
    by shape to 0."""
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.ops import attention as att

    for fn in (impls.matmul_bias_act, impls.matmul_bias_act_int8,
               att.flash_attention, att.paged_decode_attention):
        fn.launches = 0
    impls.matmul_bias_act.shapes.clear()


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


def randomize_bn(net, seed: int, gamma=(0.1, 0.5)) -> None:
    """Seeded BN statistics and affine, as a trained network has them (with
    init's identity BN the random trunk saturates the softmax): gamma
    uniform in ``gamma``, beta and mean normal (0, 0.1), var uniform in
    (0.5, 1.5)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for name, st in net.state.items():
        n = st["mean"].numel()
        p = net.params[name]
        p["gamma"].copy_(torch.empty(n).uniform_(*gamma, generator=gen))
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
                share = float(((y - ref).abs()
                               / (atol + rtol * ref.abs())).max())
                if share >= worst.get(f"{dtype}_of_tol", 0.0):
                    worst[f"{dtype}_of_tol"] = share
                    worst[f"{dtype}_of_tol_at"] = [m, k, n, act_name]
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
        f"{worst['float32_of_tol']:.3f} (at {worst['float32_of_tol_at']}), "
        f"bfloat16 {worst['bfloat16_of_tol']:.3f} (at "
        f"{worst['bfloat16_of_tol_at']})")
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
    max |ga - gb| / max |gb|. ``skip``: param names (``bk``) or
    ``key.name`` entries (``0.b``) whose gradient is zero in exact
    arithmetic, so rounding noise on both sides: counted in the global
    error only. ``sums``: every tensor's (|a - b|^2, |a|^2, |b|^2, skipped)
    as floats, from which :func:`_per_tensor` and :func:`_scaled` work."""
    l2, maxrel, sums = [], [], {}
    num = den = 0.0
    for k in gb:
        for p in gb[k]:
            a, b = ga[k][p].double(), gb[k][p].double()
            d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
            num, den = num + d2, den + b2
            name = f"{k}.{p}"
            skipped = p in skip or name in skip
            sums[name] = (d2, float((a * a).sum()), b2, skipped)
            if skipped:
                continue
            l2.append(((d2 / max(b2, 1e-300)) ** 0.5, name))
            maxrel.append((float((a - b).abs().max()
                                 / b.abs().max().clamp_min(1e-300)), name))
    return {"global_l2": (num / den) ** 0.5,
            "tensor_l2": sorted(l2, reverse=True)[:4],
            "tensor_maxrel": sorted(maxrel, reverse=True)[:4],
            "sums": sums}


def _summary(err) -> dict:
    """:func:`_grad_errors` without its per-tensor sums, for the log."""
    return {k: v for k, v in err.items() if k != "sums"}


def _per_tensor(err) -> dict:
    """{name: relative L2 error} of every tensor not skipped."""
    return {t: (d2 / max(b2, 1e-300)) ** 0.5
            for t, (d2, _, b2, skipped) in err["sums"].items()
            if not skipped}


def _scaled(err, name, c) -> dict:
    """:func:`_grad_errors`' sums and global error had ``ga``'s tensor
    ``name`` been ``c`` times larger: |ca - b|^2 = c^2 |a|^2
    - c (|a|^2 + |b|^2 - |a - b|^2) + |b|^2."""
    sums = dict(err["sums"])
    d2, a2, b2, skipped = sums[name]
    sums[name] = (max(c * c * a2 - c * (a2 + b2 - d2) + b2, 0.0),
                  c * c * a2, b2, skipped)
    num = sum(v[0] for v in sums.values())
    den = sum(v[2] for v in sums.values())
    return {"global_l2": (num / den) ** 0.5, "sums": sums}


def _bf16_violations(ek, es, eks) -> list:
    """Where the bf16 kernel route's step-1 gradient breaks the bf16 rule
    (BF16_GRAD_FLOOR, BF16_ROUTE_FLOOR); ``ek``, ``es``, ``eks``: the
    :func:`_grad_errors` of the kernel route against float32, the stock
    route against float32 and the kernel route against the stock route.
    Each entry: [what, the kernel route's distance, the stock route's
    distance from float32]."""
    (ga, gb), (ta, tb) = BF16_GRAD_FLOOR["global"], BF16_GRAD_FLOOR["tensor"]
    (ra, rb), (rta, rtb) = (BF16_ROUTE_FLOOR["global"],
                            BF16_ROUTE_FLOOR["tensor"])
    gs = es["global_l2"]
    bad = []
    if not (ek["global_l2"] <= ga * gs + gb and math.isfinite(gs)):
        bad.append(["all vs float32", ek["global_l2"], gs])
    if not eks["global_l2"] <= ra * gs + rb:
        bad.append(["all vs stock", eks["global_l2"], gs])
    pk, ps, pks = _per_tensor(ek), _per_tensor(es), _per_tensor(eks)
    for t, s_ in ps.items():
        if not pk[t] <= ta * s_ + tb:
            bad.append([f"{t} vs float32", pk[t], s_])
        if not pks[t] <= rta * s_ + rtb:
            bad.append([f"{t} vs stock", pks[t], s_])
    return bad


def _planted_faults(ek, es, eks) -> dict:
    """The bf16 rule's own control: each tensor's kernel-route gradient in
    turn scaled by BF16_FAULT_SCALE (a wrong layer gradient) must break the
    rule. Returns the share of tensors, and of the float32 gradient's
    squared norm, whose fault is caught, and the tensors whose is not, with
    the stock route's distance from float32 on each (its bf16 noise)."""
    c = BF16_FAULT_SCALE
    ps = _per_tensor(es)
    caught, missed, w_caught, w_all = 0, [], 0.0, 0.0
    for t in ps:
        w = ek["sums"][t][2]
        w_all += w
        if _bf16_violations(_scaled(ek, t, c), es, _scaled(eks, t, c)):
            caught, w_caught = caught + 1, w_caught + w
        else:
            missed.append([t, ps[t]])
    return {"scale": c, "tensors": len(ps), "caught": caught,
            "share": caught / len(ps), "norm_share": w_caught / w_all,
            "missed": sorted(missed, key=lambda m: -m[1])[:8]}


def _state_err(sa, sb) -> float:
    """The largest BN running statistic error of ``sa`` against ``sb``,
    relative to each vector's largest magnitude."""
    return max((float((sa[k][n] - sb[k][n]).abs().max()
                      / sb[k][n].abs().max())
                for k in sb for n in sb[k]), default=0.0)


def _compare_training(torch, net, ref, ds, steps, label,
                      grad_tol=TRAIN_GRAD_L2, maxrel=TRAIN_GRAD_MAXREL,
                      skip=(), f32=None) -> dict:
    """Step-1 gradients, the first ``steps`` losses and the BN state after
    step 1 (if the graphs have any) of two graphs on the same weights and
    batch; the graphs are left trained by ``steps`` steps (``net`` through
    ``fit``). ``grad_tol``, ``maxrel``, ``skip``: the gradient limits and
    the params left out of the per-tensor ones (:func:`_grad_errors`).
    With ``f32``, the float32 stock route on the same weights, ``net`` and
    ``ref`` run the bf16 policy: the bf16 rule (BF16_*) takes the place of
    the fixed limits, and ``f32`` is trained alongside."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    models = [net, ref] + ([] if f32 is None else [f32])
    grads = [model.compute_gradient_and_score(ds) for model in models]
    (gk, lk), (gr, lr) = grads[:2]
    err = _grad_errors(gk, gr, skip)
    out = {"grad": _summary(err), "score_kernel": lk, "score_stock": lr}
    if f32 is not None:
        ek = _grad_errors(gk, grads[2][0], skip)
        es = _grad_errors(gr, grads[2][0], skip)
        bad = _bf16_violations(ek, es, err)
        out["grad"] = {
            "kernel_vs_f32": _summary(ek), "stock_vs_f32": _summary(es),
            "kernel_vs_stock": _summary(err), "violations": bad[:8],
            "stock_vs_f32_tensor_quantiles": [
                float(q) for q in np.quantile(
                    list(_per_tensor(es).values()), (0.5, 0.9, 0.99, 1.0))],
            "planted_fault": _planted_faults(ek, es, err)}
    del grads, gk, gr
    log(f"[{label}] step-1 gradients: {json.dumps(out['grad'])}")
    scores, firsts = [], []
    for model in models:
        collect, first = CollectScoresListener(), _FirstStepState()
        model.set_listeners(collect, first)
        model.fit(ListDataSetIterator([ds] * steps))
        model.set_listeners()
        scores.append(collect.scores)
        firsts.append(first.state)
    torch.cuda.synchronize()
    loss_err = [abs(a - b) / abs(b) for a, b in zip(*scores[:2])]
    out.update(losses_kernel=scores[0], losses_stock=scores[1],
               loss_rel_err=loss_err)
    if f32 is None:
        state_err = _state_err(firsts[0], firsts[1])
    else:
        out["losses_f32"] = scores[2]
        state_err = {"kernel_vs_f32": _state_err(firsts[0], firsts[2]),
                     "stock_vs_f32": _state_err(firsts[1], firsts[2])}
    out["state_rel_err"] = state_err
    log(f"[{label}] losses kernel {scores[0]} stock {scores[1]}"
        + (f" float32 {scores[2]}" if f32 is not None else "")
        + (f"; BN state after step 1 {json.dumps(state_err)}"
           if firsts[1] else ""))
    finite = all(math.isfinite(v) for v in scores[0]) and math.isfinite(lk)
    if f32 is None:
        _check_fixed(label, err, grad_tol, maxrel, loss_err, scores, finite,
                     state_err)
    else:
        _check_bf16(label, out, bad, loss_err, scores, finite, state_err)
    return out


def _check_fixed(label, grad, grad_tol, maxrel, loss_err, scores, finite,
                 state_err) -> None:
    if not (grad["global_l2"] <= grad_tol["global"]
            and grad["tensor_l2"][0][0] <= grad_tol["tensor"]
            and grad["tensor_maxrel"][0][0] <= maxrel and finite):
        raise AssertionError(f"[{label}] step-1 gradients differ: "
                             f"{_summary(grad)} (tol L2 {grad_tol}, "
                             f"max-relative {maxrel})")
    if not (loss_err[0] <= TRAIN_LOSS_RTOL[0]
            and max(loss_err) <= TRAIN_LOSS_RTOL[1]):
        raise AssertionError(f"[{label}] losses differ: {scores[0]} vs "
                             f"{scores[1]} (tol {TRAIN_LOSS_RTOL})")
    if not state_err <= TRAIN_STATE_RTOL:
        raise AssertionError(f"[{label}] BN running statistics after step 1 "
                             f"differ by {state_err:.3e} relative (tol "
                             f"{TRAIN_STATE_RTOL})")


def _check_bf16(label, out, bad, loss_err, scores, finite,
                state_err) -> None:
    fault = out["grad"]["planted_fault"]
    if bad or not finite:
        raise AssertionError(f"[{label}] bf16 kernel-route gradients break "
                             f"the bf16 rule ({BF16_GRAD_FLOOR}, "
                             f"{BF16_ROUTE_FLOOR}): {bad[:8]}")
    if fault["norm_share"] < BF16_FAULT_CAUGHT:
        raise AssertionError(f"[{label}] the bf16 rule catches a "
                             f"{fault['scale']}x layer gradient only in "
                             f"tensors holding {fault['norm_share']:.3f} "
                             f"of the gradient's squared norm (at least "
                             f"{BF16_FAULT_CAUGHT}): {fault}")
    lk, ls, l32 = scores
    la, lb = BF16_LOSS_FLOOR
    if not (loss_err[0] <= BF16_LOSS_RTOL
            and all(abs(a - c) <= la * abs(b - c) + lb * abs(c)
                    for a, b, c in zip(lk, ls, l32))):
        raise AssertionError(f"[{label}] bf16 losses: kernel {lk}, stock "
                             f"{ls}, float32 {l32} (step 1 within "
                             f"{BF16_LOSS_RTOL}, then {BF16_LOSS_FLOOR})")
    if state_err["stock_vs_f32"] and not state_err["kernel_vs_f32"] <= (
            BF16_STATE_FLOOR[0] * state_err["stock_vs_f32"]
            + BF16_STATE_FLOOR[1]):
        raise AssertionError(f"[{label}] bf16 BN state after step 1: "
                             f"{state_err} ({BF16_STATE_FLOOR})")


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
    float32 column sums of y and of y * y (a float32 y is summed as it
    is; a bfloat16 y is widened first, as the kernel sums it)."""
    y = F.linear(x, w)
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


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

# [9] / [13] at LearnedSelfAttentionLayer's geometry ([28]): (B, H, Tq, Tk,
# D), learned queries against a sequence, non-causal, a ragged key mask
# with lengths in [Tk/2, Tk] (chip_sequence.seq_mask)
SEQ_ATTN_CASES = ((32, 4, 8, 512, 64), (32, 4, 1, 512, 64))


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


def suffix_flash_cases():
    """(B, Tq, Tk, D, causal, masked) of [9]'s suffix-prefill cases: a
    group of 8 suffixes of bucket ts against Tpre + ts keys (the prefix
    bucket's pages, then the suffix), causal (off = Tk - Tq: every prefix
    key visible), with the holed key mask of :func:`_suffix_mask`."""
    return [(8, ts, tpre + ts, GEN_HEAD_DIM, True, True)
            for tpre in SUFFIX_PREFIX_BUCKETS for ts in SUFFIX_BUCKETS]


def _suffix_mask(torch, gen, dev, b, ts, tpre, lens=None):
    """[B, Tpre + ts] key mask of a suffix-prefill group: each row's prefix
    valid to its length (< Tpre: the hole), padding to Tpre, then its
    suffix valid to its length. ``lens`` = (prefix lengths, suffix
    lengths) of an engine's group (its padding rows 0 and 0); without it
    they are drawn, prefixes in [Tpre/2, Tpre), and the last row is group
    padding (no valid key)."""
    if lens is not None:
        plen, slen = (torch.as_tensor(x, device=dev) for x in lens)
    else:
        plen = torch.randint(tpre // 2, tpre, (b,), generator=gen,
                             device=dev)
        slen = torch.randint(1, ts + 1, (b,), generator=gen, device=dev)
        plen[-1] = slen[-1] = 0
    pre = torch.arange(tpre, device=dev)[None, :] < plen[:, None]
    suf = torch.arange(ts, device=dev)[None, :] < slen[:, None]
    return torch.cat([pre, suf], dim=1).float()


def _attention_inputs(torch, gen, dev, b, t, masked, dtype, tk=None,
                      d=GEN_HEAD_DIM, h=None):
    """q [B, H, T, D], k, v [B, H, Tk, D] (Tk = T, H = 12 unless given)
    and a float [B, Tk] length mask (the last row of a join group of 2 or
    more has length 0, as padding rows do), or None."""
    tk = t if tk is None else tk
    h = GEN_MODEL["n_heads"] if h is None else h
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


def check_flash(torch, att, dev, cases=None, suffix=True) -> dict:
    """flash_attention vs flash_attention_plain on the card at every case
    of :func:`flash_cases` (or ``cases``), :func:`suffix_flash_cases`
    (unless ``suffix`` is False) and ``SEQ_ATTN_CASES``, float32 and
    bfloat16: o, l and m on the rows with a valid key, and every row
    finite. Also: a CUDA input that requires grad gets its gradient
    through the backward kernels."""
    import chip_sequence

    gen = torch.Generator(device=dev).manual_seed(2024)
    worst = {}

    def check(b, tq, tk, d, causal, q, k, v, km, dtype):
        o, l, m = att.flash_attention(q, k, v, km, causal, return_stats=True)
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

    for b, tq, tk, d, causal, masked in (flash_cases() if cases is None
                                         else cases):
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            q, k, v, km = _attention_inputs(torch, gen, dev, b, tq, masked,
                                            tdt, tk=tk, d=d)
            check(b, tq, tk, d, causal, q, k, v, km, dtype)
        zero = "" if not masked or b < 2 else ", a fully masked row finite"
        log(f"[9] flash_attention B={b} Tq={tq} Tk={tk} D={d} "
            f"causal={causal} masked={masked}: f32 and bf16 o, l, m within "
            f"tolerance{zero}")
    for b, h, tq, tk, d in SEQ_ATTN_CASES:
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            q, k, v, _ = _attention_inputs(torch, gen, dev, b, tq, False,
                                           tdt, tk=tk, d=d, h=h)
            km = chip_sequence.seq_mask(torch, gen, dev, b, tk)
            check(b, tq, tk, d, False, q, k, v, km, dtype)
        log(f"[9] flash_attention at the learned-query geometry B={b} "
            f"H={h} Tq={tq} Tk={tk} D={d} non-causal, lengths in "
            f"[{tk // 2}, {tk}]: f32 and bf16 o, l, m within tolerance")
    for b, tq, tk, d, causal, _ in (suffix_flash_cases() if suffix else ()):
        for dtype, tdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            q, k, v, _ = _attention_inputs(torch, gen, dev, b, tq, False,
                                           tdt, tk=tk, d=d)
            km = _suffix_mask(torch, gen, dev, b, tq, tk - tq)
            check(b, tq, tk, d, causal, q, k, v, km, dtype)
        log(f"[9] flash_attention suffix prefill B={b} Tq={tq} Tk={tk} "
            f"(prefix bucket {tk - tq}, holed mask, a group-padding row): "
            f"f32 and bf16 o, l, m within tolerance, every row finite")
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


def _bwd_inputs(torch, gen, dev, b, tq, tk, d, masked, zero_row=False,
                h=None):
    """f32 q [B, H, Tq, D], k, v [B, H, Tk, D] (H = 12 unless given), do
    like q, and a [B, Tk] length mask (lengths >= 1, or the last row of
    length 0), or None."""
    h = GEN_MODEL["n_heads"] if h is None else h
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


def check_flash_bwd(torch, att, dev, cases=None) -> dict:
    """[13] flash_attention_bwd (the dq and dk/dv kernels) vs
    flash_attention_bwd_plain on the card, at every case of
    :func:`flash_bwd_cases` (or ``cases``) and ``SEQ_ATTN_CASES``, float32
    and bfloat16, on the kernel forward's o, l, m; a length-0 row leaves
    every gradient finite; then the whole Function (kernel forward and
    backward) vs autograd of reference_attention in float64."""
    import chip_sequence

    gen = torch.Generator(device=dev).manual_seed(2026)
    worst = {}
    # (B, H or None for 12, Tq, Tk, D, causal, masked): SEQ_ATTN_CASES with
    # chip_sequence.seq_mask's ragged lengths
    cases = [(b, None, tq, tk, d, causal, masked) for b, tq, tk, d, causal,
             masked in (flash_bwd_cases() if cases is None else cases)]
    seq = [(b, h, tq, tk, d, False, True) for b, h, tq, tk, d in
           SEQ_ATTN_CASES]

    def inputs(b, h, tq, tk, d, masked):
        q, k, v, do, km = _bwd_inputs(torch, gen, dev, b, tq, tk, d, masked,
                                      h=h)
        if h is not None:
            km = chip_sequence.seq_mask(torch, gen, dev, b, tk)
        return q, k, v, do, km

    for b, h, tq, tk, d, causal, masked in cases + seq:
        q32, k32, v32, do32, km = inputs(b, h, tq, tk, d, masked)
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
        heads = "" if h is None else f" H={h}"
        log(f"[13] flash_attention_bwd B={b}{heads} Tq={tq} Tk={tk} D={d} "
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
    for b, h, tq, tk, d, causal, masked in cases[1::3] + seq[:1]:
        q, k, v, do, km = inputs(b, h, tq, tk, d, masked)
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


def _last_logits(torch, dec, seq):
    """``dec``'s prefill logits after the tokens ``seq`` (its stock or
    kernel route, as configured)."""
    with torch.inference_mode():
        logits, _ = dec._run_prompt(
            dec.params, torch.tensor([seq], device=dec.device),
            torch.tensor([len(seq)], device=dec.device))
    return logits[0].float()


def compare_streams(torch, ref_dec, got, ref, prompts, label,
                    phase="[11]") -> dict:
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
        top2 = torch.topk(_last_logits(torch, ref_dec, list(p) + list(r[:i])),
                          2).values
        gap = float(top2[0] - top2[1])
        log(f"{phase} {label}: request {j} diverges at step {i}: reference "
            f"top-2 logit gap {gap:.3e} (limit {2 * GEN_LOGIT_ATOL:.1e})")
        if gap >= 2 * GEN_LOGIT_ATOL:
            raise AssertionError(f"{label}: request {j} diverges at step {i}"
                                 f" with a top-2 gap of {gap:.3e}")
        out["near_ties"].append({"request": j, "step": i, "gap": gap})
    return out


def compare_sampled(torch, ref_dec, got, ref, prompt, temp, seed,
                    label) -> dict:
    """A seeded sampled stream against the sequential sampler's: identical,
    or parting at a step where the reference's Gumbel-perturbed scores
    ``logits / temp - log(-log u)`` (u replayed from the request's
    generator: draw i picks token i) have a top-2 gap below
    2 * GEN_LOGIT_ATOL / temp. Otherwise the run fails."""
    from deeplearning4j_tpu_torch.nn.decoding import request_generator

    i = _first_divergence(got, ref)
    if i is None:
        return {"identical": True}
    logits = _last_logits(torch, ref_dec, list(prompt) + list(ref[:i]))
    g = request_generator(seed, ref_dec.device)
    for _ in range(i + 1):
        u = torch.rand(logits.shape[-1], generator=g, device=logits.device)
    z = logits / temp - torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny)))
    top2 = torch.topk(z, 2).values
    gap, limit = float(top2[0] - top2[1]), 2 * GEN_LOGIT_ATOL / temp
    log(f"[20] {label}: diverges at step {i}: perturbed top-2 gap "
        f"{gap:.3e} (limit {limit:.1e})")
    if gap >= limit:
        raise AssertionError(f"{label}: diverges at step {i} with a "
                             f"perturbed top-2 gap of {gap:.3e}")
    return {"identical": False, "step": i, "gap": gap}


def _sweep(eng, prompts, max_new, eos=None, extra=None):
    """Submit every request to ``eng`` at once and wait for all: outputs,
    the requests and the host-clock latencies. ``max_new`` is one count or
    one per request; ``extra`` maps a request index to more ``submit``
    arguments (temperature, seed)."""
    eos, extra = eos or {}, extra or {}
    counts = (max_new if isinstance(max_new, (list, tuple))
              else [max_new] * len(prompts))
    t0 = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=counts[j], eos_id=eos.get(j),
                       **extra.get(j, {}))
            for j, p in enumerate(prompts)]
    outs = [eng.result(r) for r in reqs]
    wall = time.monotonic() - t0
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
    }


def _engine_run(torch, dec, prompts, max_new, eos=None, extra=None,
                **config):
    """One engine (GEN_CONFIG, updated by ``config``) over the requests,
    all submitted at once: outputs, the host-clock latencies and the
    engine's stats."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    with GenerationEngine(dec, GenerationConfig(**dict(GEN_CONFIG,
                                                       **config))) as eng:
        outs, timing = _sweep(eng, prompts, max_new, eos, extra)
        stats = eng.stats()
    return outs, timing, stats


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
            "seq": seq, "eos": eos, "zoo": zoo,
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


def _decode_row(torch, F, att, dev, gen, s, count) -> dict:
    """One decode-kernel timing row at KV bucket ``s``: 8 rows x 12 heads x
    64 at seeded positions in [S/2, S), the kernel (CUDA events and device
    time), its plain version, SDPA with a live-slot mask and the bound;
    ``count`` is the launches the engine run made at this bucket."""
    h, d = GEN_MODEL["n_heads"], GEN_HEAD_DIM
    pos = torch.randint(s // 2, s, (8,), generator=gen,
                        device=dev).to(torch.int32)
    q = torch.randn((8, h, d), generator=gen, device=dev)
    kc, vc = (torch.randn((8, s, h, d), generator=gen, device=dev)
              for _ in range(2))
    live = (torch.arange(s, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    err = float((att.paged_decode_attention(q, kc, vc, pos)
                 - att.paged_decode_attention_plain(q, kc, vc, pos))
                .abs().max())
    ops_ms, bytes_ms = decode_bound_ms(pos.tolist(), s, h, d, 4)
    return {
        "s": s, "positions": pos.tolist(), "count": count,
        "max_abs_err": err,
        "ms": cuda_time_ms(lambda: att.paged_decode_attention(q, kc, vc, pos)),
        "device_ms": device_ms(
            lambda: att.paged_decode_attention(q, kc, vc, pos), ["decode"]),
        "plain_ms": cuda_time_ms(
            lambda: att.paged_decode_attention_plain(q, kc, vc, pos)),
        "library_ms": cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=live)),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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
        decode_rows.append(_decode_row(
            torch, F, att, dev, gen, int(key),
            n * GEN_CONFIG["fused_steps"] * n_layers))
    return flash_rows, decode_rows


def shape_summary(rows, launches, scope) -> dict:
    """A kernel's timings at one phase's shapes, weighted by the phase's
    launches at each."""
    return {"launches": launches, "scope": scope,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": _weighted(rows, "ms"),
            "plain_ms": _weighted(rows, "plain_ms"),
            "library_ms": _weighted(rows, "library_ms"),
            "bound_ms": _weighted(rows, "bound_ms"),
            "bound_tc_ms": _weighted(rows, "bound_tc_ms"),
            "bound_by": max(("operations", "bytes"), key=lambda k: sum(
                r["count"] for r in rows if r["bound_by"] == k)),
            "shapes": rows}


def attention_report(rows, launches, worst, name, source, replaces,
                     scope) -> dict:
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           **shape_summary(rows, launches[name], scope), "checked": worst}
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
# the decode features: the prefix cache and speculative decoding
# ---------------------------------------------------------------------------

def prefix_requests(vocab: int, seed: int):
    """[19]'s traffic: a seeded PREFIX_LEN-token shared prefix (a system
    prompt). The cold sweep: 16 requests, the prefix and a distinct tail
    of PREFIX_TAIL tokens each. The hot sweep: 8 follow-up turns (a cold
    prompt and PREFIX_FOLLOW_UP more tokens: multi-turn chat, hitting the
    cold prompt's own pages) and 8 new users (the prefix and a new tail),
    interleaved, so one suffix group mixes prefix lengths."""
    rng = np.random.default_rng(seed)

    def draw(lo, hi):
        return [int(t) for t in rng.integers(0, vocab, int(rng.integers(
            lo, hi + 1)))]

    shared = draw(PREFIX_LEN, PREFIX_LEN)
    cold = [shared + draw(*PREFIX_TAIL) for _ in range(GEN_REQUESTS)]
    follow = [cold[j] + draw(*PREFIX_FOLLOW_UP)
              for j in range(GEN_REQUESTS // 2)]
    new = [shared + draw(*PREFIX_TAIL) for _ in range(GEN_REQUESTS // 2)]
    hot = [r for pair in zip(follow, new) for r in pair]
    return cold, hot


def _pinned(cache) -> int:
    """Pins held on the prefix cache's pages (0 when every request has
    released its path)."""
    with cache._lock:
        total, stack = 0, [cache._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                stack.append(child)
                total += child.refs
        return total


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n - before.get(k, 0)}


def _kernel_launches(att) -> dict:
    return {"flash_attention": att.flash_attention.launches,
            "paged_decode_attention": att.paged_decode_attention.launches}


def _group_spy(dec, groups):
    """A stand-in for ``dec.suffix_prompt_fn`` that runs the decoder's own
    and notes each suffix prefill's geometry and per-row prefix and suffix
    lengths (padding rows 0 and 0) in ``groups``, so the kernel can be
    timed under the masks the engine built."""
    def make(ts, tpre, bp):
        fn = type(dec).suffix_prompt_fn(dec, ts, tpre, bp)

        def call(params, suffix, suf_lens, prefix_kv, prefix_lens, *rest):
            groups.append({"ts": ts, "tpre": tpre,
                           "plens": [int(x) for x in prefix_lens],
                           "slens": [int(x) for x in suf_lens]})
            return fn(params, suffix, suf_lens, prefix_kv, prefix_lens,
                      *rest)
        return call
    return make


def serve_prefix(torch, dev, gen) -> dict:
    """[19] The prefix cache on [11]'s GPT-2-small-width LM (kernel route):
    a cold sweep, then a hot sweep, through one GenerationEngine with
    PREFIX_CONFIG; launches counted over the hot sweep alone (12 flash per
    prefill or suffix prefill, 12 paged per decode step); every stream held
    against sequential generate and against the same engine on the stock
    route (use_kernels=False), under the near-tie rule; at least 16 hits
    in the hot sweep and no pin left after close."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )
    from deeplearning4j_tpu_torch.ops import attention as att

    dec, stock, n_layers = gen["dec"], gen["stock"], GEN_MODEL["n_layers"]
    cold, hot = prefix_requests(gen["zoo"].vocab_size, PREFIX_SEED)
    cfg = GenerationConfig(**dict(GEN_CONFIG, **PREFIX_CONFIG))
    page_mb = (PREFIX_CONFIG["prefix_page"] * n_layers * 2
               * GEN_MODEL["embed_dim"] * 4 / 1e6)  # k and v, float32
    t0 = time.monotonic()
    warm = dec.warmup(
        prompt_buckets=(8,) + SUFFIX_BUCKETS + SUFFIX_PREFIX_BUCKETS,
        join_buckets=(GEN_CONFIG["max_batch"],),
        kv_buckets=(GEN_KV_LADDER[0],), fused_steps=(), prefix=True)
    log(f"[19] warmup: {len(warm['prefix'])} suffix-prefill geometries "
        f"(prefix bucket, suffix bucket) in {time.monotonic() - t0:.1f} s")
    groups = []  # the kernel engine's hot-sweep suffix prefills
    out = {"requests": {"cold": len(cold), "hot": len(hot)},
           "prefix_len": PREFIX_LEN, "config": dict(GEN_CONFIG,
                                                   **PREFIX_CONFIG),
           "suffix_groups": groups}
    for side, d in (("kernel", dec), ("stock", stock)):
        with GenerationEngine(d, dataclasses.replace(cfg)) as eng:
            outs_c, t_cold = _sweep(eng, cold, GEN_MAX_NEW)
            st0 = eng.stats()
            if side == "kernel":
                for fn in (att.flash_attention, att.paged_decode_attention):
                    fn.launches = 0
                d.suffix_prompt_fn = _group_spy(d, groups)
            try:
                outs_h, t_hot = _sweep(eng, hot, GEN_MAX_NEW)
            finally:
                vars(d).pop("suffix_prompt_fn", None)
            torch.cuda.synchronize()
            launches = _kernel_launches(att)
            st1 = eng.stats()
            cache = eng._prefix
        if _pinned(cache):
            raise AssertionError(f"[19] {side}: {_pinned(cache)} prefix "
                                 "pins left after close")
        pc0, pc1 = st0["prefix_cache"], st1["prefix_cache"]
        hot_stats = {
            "prefill_s": st1["prefill_seconds"] - st0["prefill_seconds"],
            "decode_s": st1["decode_seconds"] - st0["decode_seconds"],
            "hits": pc1["hits"] - pc0["hits"],
            "misses": pc1["misses"] - pc0["misses"],
            "pages": pc1["pages"], "evictions": pc1["evictions"],
            "prefills": _delta(st1["prefills"], st0["prefills"]),
            "suffix_prefills": _delta(st1["suffix_prefills"],
                                      st0["suffix_prefills"]),
            "windows": _delta(st1["windows"], st0["windows"])}
        cold_stats = {"prefill_s": st0["prefill_seconds"],
                      "decode_s": st0["decode_seconds"],
                      "prefills": st0["prefills"], "windows": st0["windows"]}
        out[side] = {"cold": t_cold, "hot": t_hot, "hot_stats": hot_stats,
                     "cold_stats": cold_stats, "cold_hits": pc0["hits"],
                     "outs": outs_c + outs_h}
        log(f"[19] {side} route: cold sweep TTFT p50/p95 "
            f"{t_cold['ttft_ms_p50']:.1f} / {t_cold['ttft_ms_p95']:.1f} ms, "
            f"{t_cold['tokens_per_s']:.1f} tokens/s ({pc0['hits']} hits); "
            f"hot sweep {t_hot['ttft_ms_p50']:.1f} / "
            f"{t_hot['ttft_ms_p95']:.1f} ms, {t_hot['tokens_per_s']:.1f} "
            f"tokens/s, {hot_stats['hits']} hits, {hot_stats['misses']} "
            f"misses; {pc1['pages']} pages held ({pc1['pages'] * page_mb:.1f}"
            f" MB on the card), "
            f"{pc1['evictions']} evicted, no pins left after close; "
            f"prefill / decode seconds cold {cold_stats['prefill_s']:.3f} / "
            f"{cold_stats['decode_s']:.3f} (prefills "
            f"{json.dumps(st0['prefills'])}), hot {hot_stats['prefill_s']:.3f}"
            f" / {hot_stats['decode_s']:.3f} (suffix prefills "
            f"{json.dumps(hot_stats['suffix_prefills'])})")
        if hot_stats["hits"] < len(hot):
            raise AssertionError(f"[19] {side}: {hot_stats['hits']} hits in "
                                 f"the hot sweep, expected {len(hot)}")
        if side == "kernel":
            by_shape = {}
            for key, n in hot_stats["suffix_prefills"].items():
                ts, tpre = (int(v) for v in key.split("x"))
                by_shape[f"{ts}x{tpre + ts}"] = n * n_layers
            for key, n in hot_stats["prefills"].items():
                tp = int(key.split("x")[0])
                by_shape[f"{tp}x{tp}"] = (by_shape.get(f"{tp}x{tp}", 0)
                                          + n * n_layers)
            steps = sum(hot_stats["windows"].values()) \
                * GEN_CONFIG["fused_steps"]
            log(f"[19] hot sweep launches {json.dumps(launches)}: flash by "
                f"(Tq x Tk) {json.dumps(by_shape)}, {steps} decode steps")
            if launches["flash_attention"] != sum(by_shape.values()) \
                    or not launches["flash_attention"]:
                raise AssertionError(
                    f"[19] flash_attention launched "
                    f"{launches['flash_attention']} times, expected "
                    f"{sum(by_shape.values())}")
            if launches["paged_decode_attention"] != n_layers * steps \
                    or not steps:
                raise AssertionError(
                    f"[19] paged_decode_attention launched "
                    f"{launches['paged_decode_attention']} times, expected "
                    f"{n_layers * steps}")
            out["launches"] = launches
            out["flash_by_shape"] = by_shape
    prompts = cold + hot
    t0 = time.monotonic()
    seq = [dec.generate(p, GEN_MAX_NEW) for p in prompts]
    out["engine_vs_sequential"] = compare_streams(
        torch, dec, out["kernel"]["outs"], seq, prompts,
        "prefix-cache engine vs sequential generate", phase="[19]")
    out["kernel_vs_stock"] = compare_streams(
        torch, stock, out["kernel"]["outs"], out["stock"]["outs"], prompts,
        "prefix-cache engine, kernel vs use_kernels=False", phase="[19]")
    log(f"[19] streams: engine vs sequential "
        f"{out['engine_vs_sequential']['identical']}/{len(prompts)} "
        f"identical, kernel vs stock engine "
        f"{out['kernel_vs_stock']['identical']}/{len(prompts)} identical "
        f"(sequential references in {time.monotonic() - t0:.1f} s)")
    out["prompts"], out["seq"] = prompts, seq
    return out


def suffix_flash_bound_ms(plens, slens, tq, tk, h, d, size):
    """(operations ms, bytes ms) of one suffix-prefill flash launch at a
    group's own lengths: row b's live query i (i < slens[b]) sees its
    plens[b] valid prefix keys and suffix keys 0..i (causal), 4·D
    operations a (query, key) pair per head; the live q rows and the live
    K and V rows read once, the key mask read once, o written whole
    (padding rows and prefix padding need no work)."""
    pairs = sum(s * p + s * (s + 1) / 2 for p, s in zip(plens, slens))
    rows_kv = sum(p + s for p, s in zip(plens, slens))
    b = len(plens)
    ops = 4.0 * h * pairs * d
    nbytes = (h * d * (sum(slens) + 2 * rows_kv + b * tq) * size
              + b * tk * 4)
    return (ops / PEAK_OPS_PER_S["float32"] * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def time_suffix_flash(torch, F, att, dev, groups, n_layers) -> list:
    """[19] The flash kernel at each of the hot sweep's suffix prefills, as
    the engine ran it: 8 rows x 12 heads x Tq = ts against Tk = tpre + ts
    keys, f32, seeded q, k, v under the group's own holed key mask (its
    prefix and suffix lengths, its padding rows); the kernel, its plain
    version, SDPA with the boolean causal (off = Tk - Tq) + key mask, and
    the bound of the group's live work."""
    gen = torch.Generator(device=dev).manual_seed(78)
    h, d = GEN_MODEL["n_heads"], GEN_HEAD_DIM
    rows = []
    for g in groups:
        ts, tpre, b = g["ts"], g["tpre"], len(g["plens"])
        tk = tpre + ts
        q, k, v, _ = _attention_inputs(torch, gen, dev, b, ts, False,
                                       torch.float32, tk=tk)
        km = _suffix_mask(torch, gen, dev, b, ts, tpre,
                          lens=(g["plens"], g["slens"]))
        keep = ((torch.arange(tk, device=dev)[None, :]
                 <= torch.arange(ts, device=dev)[:, None] + tpre)[None, None]
                & (km > 0)[:, None, None, :])
        valid = km.sum(-1) > 0
        err = float((att.flash_attention(q, k, v, km, True)
                     - att.flash_attention_plain(q, k, v, km, True)[0])
                    [valid].abs().max())
        ops_ms, bytes_ms = suffix_flash_bound_ms(g["plens"], g["slens"], ts,
                                                 tk, h, d, 4)
        rows.append({
            "b": b, "tq": ts, "tk": tk, "count": n_layers,
            "prefix_lens": g["plens"], "suffix_lens": g["slens"],
            "max_abs_err": err,
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
    return rows


def _spec_decoders(torch, dev, gen):
    """[20]'s drafts, use_kernels, with the target's bucket geometry: an
    oracle (the target's configuration and seed, built anew: its weights
    must equal the target's) and a DistilGPT2-width draft (DRAFT_MODEL,
    DRAFT_SEED)."""
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    dec_kw = {k: GEN_CONFIG[k] for k in ("max_batch", "kv_bucket_min",
                                         "prompt_bucket_min")}
    oracle = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                seed=GEN_SEED, **GEN_MODEL).decoder(
        device=dev, **dec_kw)
    tp, op = gen["dec"].params, oracle.params
    if not all(torch.equal(tp[n][k], op[n][k]) for n in tp for k in tp[n]):
        raise AssertionError("[20] the oracle draft's weights differ from "
                             "the target's")
    distil = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                seed=DRAFT_SEED, **DRAFT_MODEL).decoder(
        device=dev, **dec_kw)
    return {"oracle": oracle, "distilgpt2": distil}


def spec_requests(gen):
    """[20]'s traffic: [11]'s 16 greedy prompts (its eos request too), one
    prompt of max_len - K tokens decoding to the context edge (while it
    runs, max_pos + K + 1 > max_len: every window is the plain fallback),
    and two sampled requests (SPEC_SAMPLED, prompts of 16 to max_len / 4
    tokens)."""
    rng = np.random.default_rng(GEN_SEED + 20)
    vocab, max_len = gen["zoo"].vocab_size, GEN_MODEL["max_len"]
    prompts = list(gen["prompts"])
    max_new = [gen["max_new"]] * len(prompts)
    edge = max_len - SPEC_TOKENS
    prompts.append([int(t) for t in rng.integers(0, vocab, edge)])
    max_new.append(max_len - edge)
    extra = {}
    for temp, seed in SPEC_SAMPLED:
        extra[len(prompts)] = {"temperature": temp, "seed": seed}
        prompts.append([int(t) for t in rng.integers(
            0, vocab, int(rng.integers(16, max_len // 4 + 1)))])
        max_new.append(SPEC_SAMPLED_NEW)
    return prompts, max_new, extra


def serve_spec(torch, dev, gen, drafts) -> dict:
    """[20] Speculative decoding: [11]'s target (kernel route) with
    spec_tokens=SPEC_TOKENS and each draft in turn, over
    :func:`spec_requests`; launches counted over each run alone (12 flash
    per target prefill and draft-layers per draft prefill; 12 paged per
    fallback step and draft-layers per draft step); greedy streams held
    against sequential generate (near-tie rule), sampled streams against
    the sequential sampler with the same seed; the oracle's acceptance above
    0 (the seeded draft's is reported); the fallback window used."""
    from deeplearning4j_tpu_torch.ops import attention as att

    dec, n_layers = gen["dec"], GEN_MODEL["n_layers"]
    prompts, max_new, extra = spec_requests(gen)
    n_greedy = len(gen["prompts"])
    t0 = time.monotonic()
    ref = list(gen["seq"]) + [dec.generate(prompts[n_greedy],
                                           max_new[n_greedy])]
    for j, kw in extra.items():
        ref.append(dec.generate(prompts[j], max_new[j],
                                temperature=kw["temperature"],
                                seed=kw["seed"]))
    log(f"[20] sequential references of the edge and sampled requests in "
        f"{time.monotonic() - t0:.1f} s")
    out = {"requests": len(prompts), "spec_tokens": SPEC_TOKENS,
           "draft_models": {"oracle": dict(GEN_MODEL, seed=GEN_SEED),
                            "distilgpt2": dict(DRAFT_MODEL,
                                               seed=DRAFT_SEED)}}
    for name, draft in drafts.items():
        dl = len(draft._attn)
        t0 = time.monotonic()
        draft.warmup(fused_steps=(), spec_draft=(SPEC_TOKENS,))
        dec.warmup(prompt_buckets=dec.prompt_ladder[:1], join_buckets=(1,),
                   fused_steps=(), spec_steps=(SPEC_TOKENS,))
        log(f"[20] {name} draft ({dl} layers): warmup in "
            f"{time.monotonic() - t0:.1f} s")
        for fn in (att.flash_attention, att.paged_decode_attention):
            fn.launches = 0
        outs, timing, stats = _engine_run(
            torch, dec, prompts, max_new, gen["eos"], extra,
            draft_conf=draft, spec_tokens=SPEC_TOKENS)
        torch.cuda.synchronize()
        launches = _kernel_launches(att)
        sp = stats["speculative"]
        fallback = sum(stats["windows"].values()) * GEN_CONFIG["fused_steps"]
        verify = sum(sp["verify_windows"].values())
        want = {"flash_attention": n_layers * sum(stats["prefills"].values())
                + dl * sp["draft_prefills"],
                "paged_decode_attention": n_layers * fallback
                + dl * SPEC_TOKENS * verify}
        log(f"[20] {name} draft: {timing['tokens']} tokens in "
            f"{timing['wall_s']:.2f} s ({timing['tokens_per_s']:.1f} "
            f"tokens/s), acceptance {sp['acceptance']:.4f} "
            f"({sp['accepted']}/{sp['drafted']} drafted tokens over "
            f"{sp['windows']} row windows), {verify} verify steps "
            f"{json.dumps(sp['verify_windows'])}, {fallback} fallback "
            f"steps, {sp['draft_prefills']} draft prefills; launches "
            f"{json.dumps(launches)} (the draft's paged decode "
            f"{dl * SPEC_TOKENS * verify})")
        if launches != want or not all(launches.values()):
            raise AssertionError(f"[20] {name}: launches {launches}, "
                                 f"expected {want}")
        if name == "oracle" and not sp["acceptance"] > 0:
            raise AssertionError("[20] the oracle draft: acceptance 0")
        if not fallback:
            raise AssertionError(f"[20] {name}: the edge request ran no "
                                 "fallback window")
        greedy = list(range(n_greedy + 1))
        row = {"timing": timing, "speculative": sp, "launches": launches,
               "fallback_steps": fallback,
               "draft_paged_launches": dl * SPEC_TOKENS * verify,
               "greedy_vs_sequential": compare_streams(
                   torch, dec, [outs[j] for j in greedy],
                   [ref[j] for j in greedy], [prompts[j] for j in greedy],
                   f"{name} draft vs sequential generate", phase="[20]"),
               "sampled_vs_sequential": [compare_sampled(
                   torch, dec, outs[j], ref[j], prompts[j],
                   kw["temperature"], kw["seed"],
                   f"{name} draft, sampled request {j}")
                   for j, kw in extra.items()]}
        log(f"[20] {name} draft: greedy streams "
            f"{row['greedy_vs_sequential']['identical']}/{len(greedy)} "
            f"identical to sequential generate; sampled "
            f"{sum(r['identical'] for r in row['sampled_vs_sequential'])}"
            f"/{len(extra)} identical to the sequential sampler")
        out[name] = row
    return out


def spec_throughput(torch, gen, drafts, smi: str) -> dict:
    """[20] Tokens/s over [11]'s 16 greedy requests: [11]'s plain engine
    and the speculating engine with each draft, in turns (plain, oracle,
    distilgpt2, distilgpt2, oracle, plain); medians per engine."""
    turns = ["plain"] + list(drafts) + list(drafts)[::-1] + ["plain"]
    runs = {t: [] for t in turns}
    for t in turns:
        cfg = {} if t == "plain" else {"draft_conf": drafts[t],
                                       "spec_tokens": SPEC_TOKENS}
        _, timing, _ = _engine_run(torch, gen["dec"], gen["prompts"],
                                   gen["max_new"], **cfg)
        runs[t].append(timing)
    out = {"card": smi, "turns": turns}
    for t, v in runs.items():
        for key in ("tokens_per_s", "ttft_ms_p50", "token_ms_p50"):
            out[f"{key}_{t}"] = statistics.median(r[key] for r in v)
    return out


def serve_prefix_spec(torch, gen, pre, drafts) -> dict:
    """[20] Both features at once: [19]'s cold and hot sweeps through one
    engine with PREFIX_CONFIG and the oracle draft (the seeded DistilGPT2
    width accepts nothing: with it no drafted token would follow a prefix
    hit); streams held against [19]'s sequential references; the hot
    sweep must hit the cache for every request and accept drafted tokens
    (the draft prefilled the whole prompt of a hit row and synced behind
    its attached pages); no pin left after close."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    cfg = GenerationConfig(**dict(GEN_CONFIG, **PREFIX_CONFIG),
                           draft_conf=drafts["oracle"],
                           spec_tokens=SPEC_TOKENS)
    half = len(pre["prompts"]) // 2
    with GenerationEngine(gen["dec"], cfg) as eng:
        outs, t_cold = _sweep(eng, pre["prompts"][:half], GEN_MAX_NEW)
        st0 = eng.stats()
        hot, t_hot = _sweep(eng, pre["prompts"][half:], GEN_MAX_NEW)
        st1 = eng.stats()
        cache = eng._prefix
    if _pinned(cache):
        raise AssertionError("[20] prefix + spec: pins left after close")
    same = compare_streams(torch, gen["dec"], outs + hot, pre["seq"],
                           pre["prompts"],
                           "prefix cache + oracle draft vs sequential",
                           phase="[20]")
    hits = st1["prefix_cache"]["hits"] - st0["prefix_cache"]["hits"]
    sp0, sp1 = st0["speculative"], st1["speculative"]
    accepted = sp1["accepted"] - sp0["accepted"]
    drafted = sp1["drafted"] - sp0["drafted"]
    log(f"[20] prefix cache + oracle draft: {same['identical']}/"
        f"{len(pre['prompts'])} streams identical to sequential generate; "
        f"hot sweep {hits} hits, {accepted}/{drafted} drafted tokens "
        f"accepted (whole run {sp1['acceptance']:.4f}); hot sweep TTFT "
        f"p50 {t_hot['ttft_ms_p50']:.1f} ms (cold "
        f"{t_cold['ttft_ms_p50']:.1f}), {t_hot['tokens_per_s']:.1f} "
        f"tokens/s")
    if hits < len(pre["prompts"]) - half:
        raise AssertionError(f"[20] prefix + spec: {hits} hits in the hot "
                             f"sweep, expected {len(pre['prompts']) - half}")
    if not accepted > 0:
        raise AssertionError("[20] prefix + spec: no drafted token "
                             "accepted after the hot sweep's prefix hits")
    return {"draft": "oracle", "streams": same,
            "prefix_cache": st1["prefix_cache"],
            "speculative": sp1, "hot_hits": hits,
            "hot_accepted": accepted, "hot_drafted": drafted,
            "cold": t_cold, "hot": t_hot}


def decode_features(torch, F, att, dev, gen, fl, pd, smi) -> tuple:
    """[19] and [20] on [11]'s model ``gen``: the phases, the kernels'
    timings at their shapes (added to the flash row ``fl`` and the decode
    row ``pd`` of the kernels line) and the two result lines."""
    n_layers = GEN_MODEL["n_layers"]

    # 19. the prefix cache, on [11]'s model
    pre = serve_prefix(torch, dev, gen)
    groups = pre["suffix_groups"]
    if len(groups) != sum(pre["kernel"]["hot_stats"]["suffix_prefills"]
                          .values()):
        raise AssertionError(
            f"[19] {len(groups)} suffix prefills seen, the engine's stats "
            f"count {pre['kernel']['hot_stats']['suffix_prefills']}")
    suffix_rows = time_suffix_flash(torch, F, att, dev, groups, n_layers)
    for r in suffix_rows:
        log(f"[19] flash_attention suffix prefill B={r['b']} Tq={r['tq']} "
            f"Tk={r['tk']} x{r['count']} (prefix lengths "
            f"{r['prefix_lens']}, suffix lengths {r['suffix_lens']}): "
            f"kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, FFMA), "
            f"{r['bound_tc_ms']:.4f} ms (3xTF32)")
    fl["suffix_prefill"] = shape_summary(
        suffix_rows, pre["launches"]["flash_attention"],
        "one launch of the hot sweep's suffix prefills (8 rows x 12 heads x "
        "Tq = suffix bucket against Tk = prefix bucket + Tq keys, causal, "
        "each group's own holed key mask and padding rows), float32; bound "
        "of the live (query, key) pairs and K/V rows; launches = the hot "
        "sweep's (suffix and cold prefills); library = SDPA with the "
        "boolean causal + key mask")
    sf = fl["suffix_prefill"]
    log(f"[19] per suffix-prefill launch: flash_attention {sf['ms']:.4f} ms "
        f"(plain {sf['plain_ms']:.4f}, SDPA {sf['library_ms']:.4f}, bound "
        f"{sf['bound_ms']:.4f} {sf['bound_by']}, 3xTF32 "
        f"{sf['bound_tc_ms']:.4f}) [{smi}]")

    # 20. speculative decoding, on [11]'s model
    drafts = _spec_decoders(torch, dev, gen)
    spec = serve_spec(torch, dev, gen, drafts)
    dgen = torch.Generator(device=dev).manual_seed(79)
    dl = DRAFT_MODEL["n_layers"]
    spec_rows = [_decode_row(torch, F, att, dev, dgen, int(key),
                             n * SPEC_TOKENS * dl)
                 for key, n in spec["distilgpt2"]["speculative"][
                     "verify_windows"].items()]
    for r in spec_rows:
        log(f"[20] paged_decode_attention in the distilgpt2 draft's windows "
            f"S={r['s']} x{r['count']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms), plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    pd["spec_draft"] = shape_summary(
        spec_rows, spec["distilgpt2"]["launches"]["paged_decode_attention"],
        "one launch of the distilgpt2 draft's decode steps (8 rows x 12 "
        "heads x 64 against [8, S, 12, 64] caches, seeded positions in "
        "[S/2, S)), float32, by KV bucket; launches = the whole [20] run's "
        "(draft steps and the target's fallback steps)")
    if all(r.get("device_ms") is not None for r in spec_rows):
        pd["spec_draft"]["device_ms"] = _weighted(spec_rows, "device_ms")
    spec_line = spec_throughput(torch, gen, drafts, smi)
    both = serve_prefix_spec(torch, gen, pre, drafts)
    log(f"[20] {GEN_REQUESTS} greedy requests x {GEN_MAX_NEW} tokens, in "
        f"turns: plain engine {spec_line['tokens_per_s_plain']:.1f} "
        f"tokens/s, oracle draft {spec_line['tokens_per_s_oracle']:.1f}, "
        f"distilgpt2 draft {spec_line['tokens_per_s_distilgpt2']:.1f} "
        f"[{smi}]")
    prefix_line = {
        "card": smi, "config": pre["config"], "requests": pre["requests"],
        "prefix_len": pre["prefix_len"], "launches": pre["launches"],
        "flash_by_shape": pre["flash_by_shape"],
        "engine_vs_sequential": pre["engine_vs_sequential"],
        "kernel_vs_stock": pre["kernel_vs_stock"]}
    for side in ("kernel", "stock"):
        prefix_line[side] = {k: pre[side][k] for k in (
            "cold", "hot", "hot_stats", "cold_stats", "cold_hits")}
    spec_line.update({k: spec[k] for k in ("requests", "spec_tokens",
                                           "draft_models")})
    for name in drafts:
        spec_line[name] = {k: spec[name][k] for k in (
            "timing", "speculative", "launches", "fallback_steps",
            "draft_paged_launches", "greedy_vs_sequential",
            "sampled_vs_sequential")}
    spec_line["prefix_and_spec"] = both
    return prefix_line, spec_line


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
    return _conf_pair(torch, dev, zoo.conf())


def _conf_pair(torch, dev, conf):
    """``conf``'s graph on the kernel route and the same weights on the
    stock route."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = dataclasses.replace(conf, use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    return net, ref


def _compare_lm(torch, att, net, ref, ds, steps, label, n_layers,
                f32=None) -> dict:
    """:func:`_compare_training` at the LM limits (the bf16 rule with
    ``f32``); the kernel route's compute_gradient_and_score and ``steps``
    fit steps launch each attention kernel n_layers times per forward /
    backward."""
    _reset_attention_launches(att)
    cmp = _compare_training(torch, net, ref, ds, steps, label,
                            grad_tol=LM_GRAD_L2, maxrel=LM_GRAD_MAXREL,
                            skip=LM_ZERO_GRADS, f32=f32)
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


# ---------------------------------------------------------------------------
# [21] MultiLayerNetwork training: LeNet on synthetic MNIST, the zip, and
# SimpleCNN
# ---------------------------------------------------------------------------

def mln_expected_launches(conf, forwards: int) -> int:
    """``matmul_bias_act`` launches of ``forwards`` routed forwards of the
    MultiLayerNetwork ``conf``: one per plain dense layer with an
    elementwise activation (the routing's rule; the softmax head is not
    routed)."""
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.kernels import impls

    routed = sum(1 for layer in conf.layers
                 if isinstance(layer, DenseLayer)
                 and type(layer).forward is DenseLayer.forward
                 and impls.elementwise(layer.activation))
    return routed * forwards


def _lenet_net(torch, dev, use_kernels: bool):
    from deeplearning4j_tpu_torch.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import LeNet

    conf = dataclasses.replace(
        LeNet(updater=Adam(learning_rate=LENET_LR)).conf(),
        use_kernels=use_kernels)
    return MultiLayerNetwork(conf, dev).init()


def _profile_steps(torch, net, ds, steps: int) -> dict:
    """Host time per ``fit_batch`` step and the device's kernel time over
    ``steps`` steps under ``torch.profiler``; the idle share is 1 - device
    time / wall time."""
    from torch.profiler import ProfilerActivity, profile

    net.fit_batch(ds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            net._fit_batch(ds)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / steps * 1e3
    kernels, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.device_time > 0:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time
            launches += 1
    device_ms = sum(kernels.values()) / steps / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(((e.key, e.self_cpu_time_total)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches_per_step": launches / steps,
            "top": [[name[:80], us / steps / 1e3] for name, us in top],
            "host_top": [[name[:60], us / steps / 1e3] for name, us in host]}


def mln_step_times(torch, nets: dict, ds, pairs: int = 5,
                   steps: int = 20) -> dict:
    """ms per ``fit_batch`` step (host clock around ``steps`` steps and a
    synchronize), the routes in alternating turns on copies of the trained
    nets, and examples/s."""
    times = {side: [] for side in nets}
    sides = list(nets)
    for i in range(pairs):
        for side in (sides if i % 2 == 0 else sides[::-1]):
            net = nets[side]
            net._fit_batch(ds)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(steps):
                net._fit_batch(ds)
            torch.cuda.synchronize()
            times[side].append((time.monotonic() - t0) / steps * 1e3)
    batch = ds.num_examples()
    out = {"pairs": pairs, "steps_per_turn": steps, "batch": batch}
    for side, v in times.items():
        out[f"step_ms_{side}"] = statistics.median(v)
        out[f"examples_per_s_{side}"] = batch / statistics.median(v) * 1e3
    return out


def lenet_data():
    """[21]'s seeded synthetic MNIST: the training iterator, a function
    that gives the epoch-0 batches as a fresh iterator (its shuffle is
    seeded by seed + epoch), and the test iterator."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ArrayDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator

    train = MnistDataSetIterator(batch=LENET_TRAIN["batch"], train=True,
                                 num_examples=LENET_TRAIN["num_examples"],
                                 seed=LENET_TRAIN["seed"])

    def batches():
        return ArrayDataSetIterator(train.features, train.labels,
                                    LENET_TRAIN["batch"], shuffle=True,
                                    seed=LENET_TRAIN["seed"])

    test = MnistDataSetIterator(batch=LENET_TEST["batch"], train=False,
                                num_examples=LENET_TEST["num_examples"],
                                shuffle=False)
    if not (train.synthetic and test.synthetic):
        raise AssertionError("[21] MNIST resolved to cached files, not the "
                             "seeded synthetic set")
    return train, batches, test


def lenet_fit(torch, impls, dev, use_kernels, batches, test) -> dict:
    """One [21] LeNet fit from the seeded weights: LENET_EPOCHS epochs of
    ``batches()``, then ``evaluate`` on ``test``; the net, its step
    scores, test accuracy and F1, seconds, and the matmul_bias_act
    launches over the fit and the evaluation."""
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    net = _lenet_net(torch, dev, use_kernels)
    collect = CollectScoresListener()
    net.set_listeners(collect)
    torch.cuda.synchronize()
    impls.matmul_bias_act.launches = 0
    t0 = time.monotonic()
    net.fit(batches(), epochs=LENET_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    ev = net.evaluate(test)
    net.set_listeners()
    return {"net": net, "scores": collect.scores, "accuracy": ev.accuracy(),
            "f1": ev.f1(), "fit_s": fit_s,
            "launches": impls.matmul_bias_act.launches}


def train_lenet(torch, impls, dev) -> dict:
    """[21] LeNet (the reference topology, 1,256,080 params) trained by
    ``MultiLayerNetwork.fit`` on synthetic MNIST, ``use_kernels=True``
    against ``use_kernels=False`` from the same seed; evaluated on the
    test set; launch counts over the kernel route's fit and evaluate."""
    nets, scores, accs, stats, launches = {}, {}, {}, {}, {}
    t_data = time.monotonic()
    _, batches, test = lenet_data()
    data_s = time.monotonic() - t_data
    # one step on a throwaway net per route first, so the timed fits do
    # not pay the process's first cuDNN / cuBLAS / kernel-library loads
    for use_kernels in (True, False):
        _lenet_net(torch, dev, use_kernels).fit_batch(next(iter(batches())))
    # 256 Adam steps carry the routes' 1e-7 differences into trajectories
    # that part, and late loss spikes are the training's own: under cuDNN's
    # default (non-deterministic) algorithms, 20 fits per route on an H100
    # (chip_lenet_spread.py) failed the accuracy gate in 17% of kernel x
    # stock pairs, and in 9.5% of pairs of two stock-route fits. With the
    # deterministic algorithms each route's run is the same from call to
    # call, so the gate reads one trajectory per route rather than the
    # conv backward's summation order.
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for side, use_kernels in (("kernel", True), ("stock", False)):
            fit = lenet_fit(torch, impls, dev, use_kernels, batches, test)
            nets[side], scores[side], accs[side] = (
                fit["net"], fit["scores"], fit["accuracy"])
            launches[side] = fit["launches"]
            stats[side] = {"fit_s": fit["fit_s"], "accuracy": fit["accuracy"],
                           "f1": fit["f1"], "steps": fit["net"].iteration}
            log(f"[21] LeNet {side} route: {fit['net'].iteration} steps in "
                f"{fit['fit_s']:.2f} s, test accuracy {fit['accuracy']:.4f}, "
                f"score {scores[side][0]:.5f} -> {scores[side][-1]:.5f}")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    steps = nets["kernel"].iteration
    n_eval = -(-LENET_TEST["num_examples"] // LENET_TEST["batch"])
    expected = mln_expected_launches(nets["kernel"].conf, steps + n_eval)
    log(f"[21] matmul_bias_act launches over the kernel route's fit + "
        f"evaluate: {launches['kernel']} counted, {expected} expected "
        f"({steps} steps + {n_eval} eval batches); stock route "
        f"{launches['stock']}")
    if launches["kernel"] != expected or launches["stock"] != 0:
        raise AssertionError(f"[21] matmul_bias_act launched "
                             f"{launches['kernel']} times, expected "
                             f"{expected} (stock route {launches['stock']})")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(scores["kernel"][:LENET_COMPARE], scores["stock"])]
    log(f"[21] first {LENET_COMPARE} step scores, kernel vs stock: max "
        f"relative difference {max(rel):.3e} (step 1 {rel[0]:.3e}; tol "
        f"{TRAIN_LOSS_RTOL})")
    if not (rel[0] <= TRAIN_LOSS_RTOL[0] and max(rel) <= TRAIN_LOSS_RTOL[1]
            and all(math.isfinite(v) for v in scores["kernel"])):
        raise AssertionError(f"[21] step scores differ: {rel} (tol "
                             f"{TRAIN_LOSS_RTOL})")
    if min(accs.values()) < LENET_MIN_ACC or \
            abs(accs["kernel"] - accs["stock"]) > LENET_ACC_GAP:
        raise AssertionError(f"[21] test accuracy {accs} (each must reach "
                             f"{LENET_MIN_ACC}, within {LENET_ACC_GAP})")
    return {"nets": nets, "train": batches(), "test": test,
            "scores": scores,
            "rel": rel, "stats": stats, "launches": launches,
            "expected": expected, "data_s": data_s}


def check_zip_resume(torch, dev, net, train) -> dict:
    """[21] the ModelSerializer zip on the card: write the trained net,
    restore it, hold params, updater state, layer state, counters and
    output bit for bit, then train both 5 more steps on the same batches
    and hold the params as closely as the output."""
    import tempfile

    from deeplearning4j_tpu_torch.util import serializer

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/lenet.zip"
            serializer.write_model(net, path)
            size = len(open(path, "rb").read())
            back = serializer.restore_multi_layer_network(path, device=dev)

        def tree_diff(a, b):
            return max((float((a[k][p] - b[k][p]).abs().max())
                        for k in a for p in a[k]), default=0.0)

        def opt_diff(a, b):
            return max((float((a[k][p][s] - b[k][p][s]).abs().max())
                        for k in a for p in a[k] for s in a[k][p]),
                       default=0.0)

        batches = [ds for _, ds in zip(range(LENET_RESUME_STEPS), train)]
        x = batches[0].features
        out = {
            "zip_bytes": size,
            "params": tree_diff(net.params, back.params),
            "updater_state": opt_diff(net.opt_state, back.opt_state),
            "counters": [[net.iteration, net.epoch],
                         [back.iteration, back.epoch]],
            "output": float(np.abs(net.output(x) - back.output(x)).max()),
        }
        for ds in batches:
            net.fit_batch(ds)
            back.fit_batch(ds)
        out["params_after_resume"] = tree_diff(net.params, back.params)
        out["updater_state_after_resume"] = opt_diff(net.opt_state,
                                                     back.opt_state)
    finally:
        torch.backends.cudnn.deterministic = prev
    log(f"[21] zip ({out['zip_bytes']} bytes) restored on the card: params "
        f"{out['params']}, updater state {out['updater_state']}, counters "
        f"{out['counters']}, output {out['output']} max |diff|; after "
        f"{LENET_RESUME_STEPS} more steps on both: params "
        f"{out['params_after_resume']}, updater state "
        f"{out['updater_state_after_resume']}")
    if out["params"] or out["updater_state"] or out["output"] or \
            out["counters"][0] != out["counters"][1]:
        raise AssertionError(f"[21] the restored net differs: {out}")
    if out["params_after_resume"] > out["output"] or \
            out["updater_state_after_resume"] > out["output"]:
        raise AssertionError(f"[21] the resumed training differs: {out}")
    return out


def train_simplecnn(torch, impls, dev) -> dict:
    """[21] SimpleCNN (48x48x3, three conv + BN blocks, dense 128) trained
    5 steps at batch 32, kernel route against stock (``matmul_bias_act``
    launches counted over the kernel route's gradient and steps); then the
    BN-folded serving copy against the unfolded one."""
    from deeplearning4j_tpu_torch.nn.inference_opt import (
        optimize_for_inference,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    zoo = SimpleCNN()
    zoo_conf = zoo.conf()
    nets = [MultiLayerNetwork(dataclasses.replace(zoo_conf, use_kernels=k),
                              dev).init()
            for k in (True, False)]
    ds = _synthetic_batch(zoo, SIMPLECNN_BATCH, SIMPLECNN_SEED)
    # a convolution's bias feeding a batch norm has a zero gradient in
    # exact arithmetic (the BN removes each channel's mean): rounding noise
    before_bn = tuple(f"{i}.b" for i, layer in enumerate(zoo_conf.layers[:-1])
                      if type(zoo_conf.layers[i + 1]).__name__
                      == "BatchNormalization")
    impls.matmul_bias_act.launches = 0
    out = _compare_training(torch, nets[0], nets[1], ds, SIMPLECNN_STEPS,
                            "21", skip=before_bn)
    launches = impls.matmul_bias_act.launches
    expected = mln_expected_launches(nets[0].conf, 1 + SIMPLECNN_STEPS)
    log(f"[21] SimpleCNN matmul_bias_act launches: {launches} counted, "
        f"{expected} expected (one gradient + {SIMPLECNN_STEPS} steps)")
    if launches != expected:
        raise AssertionError(f"[21] SimpleCNN launched matmul_bias_act "
                             f"{launches} times, expected {expected}")
    folded = optimize_for_inference(nets[0])
    unfolded = optimize_for_inference(nets[0], fold_bn=False)
    n_bn = [sum(type(layer).__name__ == "BatchNormalization"
                for layer in m.conf.layers) for m in (folded, unfolded)]
    a, b = folded.output(ds.features), unfolded.output(ds.features)
    atol, rtol = SERVED_TOL
    err = float(np.abs(a - b).max())
    bad = int((np.abs(a - b) > atol + rtol * np.abs(b)).sum())
    log(f"[21] SimpleCNN BN-folded ({n_bn[0]} BN left) vs unfolded "
        f"({n_bn[1]} BN) serving copies: max |diff| {err:.3e} (tol "
        f"atol={atol} rtol={rtol})")
    if bad or n_bn[0] != 0 or n_bn[1] != 3:
        raise AssertionError(f"[21] folded SimpleCNN differs: {bad} outputs "
                             f"outside tolerance, BN layers {n_bn}")
    out.update(fold_max_abs_err=err, nets=nets, ds=ds, launches=launches)
    return out


def time_mln_kernels(torch, impls, Activation, F, dev, launches) -> list:
    """Row 1 at [21]'s dense shapes: LeNet's 2450 -> 500 relu in training
    (M 64) and evaluation (M 256), SimpleCNN's 9216 -> 128 relu (M 32),
    beside the plain version, F.linear and the bound; ``count``: the
    launches per shape in [21]'s runs."""
    gen = torch.Generator(device=dev).manual_seed(21)
    act = Activation("relu")
    rows = []
    for (m, k, n), count in zip(MLN_SHAPES[:3], launches):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        b = 0.1 * torch.randn((n,), generator=gen, device=dev)
        err = float((impls.matmul_bias_act(x, w, b, act)
                     - impls.matmul_bias_act_plain(x, w, b, act)).abs().max())
        ops_ms, bytes_ms = matmul_bound_ms(m, k, n, "float32")
        rows.append({
            "m": m, "k": k, "n": n, "count": count, "max_abs_err": err,
            "ms": cuda_time_ms(lambda: impls.matmul_bias_act(x, w, b, act)),
            "plain_ms": cuda_time_ms(
                lambda: impls.matmul_bias_act_plain(x, w, b, act)),
            "library_ms": cuda_time_ms(
                lambda: torch.relu(F.linear(x, w, b))),
            "device_ms": device_ms(
                lambda: impls.matmul_bias_act(x, w, b, act),
                ("mm_bias_act",)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_tc_ms": tc_bound_ms(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        })
    return rows


def mln_training(torch, impls, Activation, F, dev, smi) -> tuple:
    """Phase [21]; returns (the ``trained_mln`` line, row 1's [21]
    shapes)."""
    lenet = train_lenet(torch, impls, dev)
    nets, test = lenet["nets"], lenet["test"]
    zip_out = check_zip_resume(torch, dev, nets["kernel"], lenet["train"])
    bench_ds = next(iter(test)).split_test_and_train(
        LENET_TRAIN["batch"])[0].migrate(dev)
    times = mln_step_times(torch, {side: net.clone()
                                   for side, net in nets.items()}, bench_ds)
    profiles = {side: _profile_steps(torch, net.clone(), bench_ds,
                                     LENET_PROFILE_STEPS)
                for side, net in nets.items()}
    log(f"[21] LeNet train step at batch {LENET_TRAIN['batch']}: kernel "
        f"route {times['step_ms_kernel']:.3f} ms "
        f"({times['examples_per_s_kernel']:.0f} examples/s), stock "
        f"{times['step_ms_stock']:.3f} ms "
        f"({times['examples_per_s_stock']:.0f} examples/s); under "
        f"torch.profiler ({LENET_PROFILE_STEPS} steps): device "
        f"{profiles['kernel']['device_ms']:.3f} / "
        f"{profiles['stock']['device_ms']:.3f} ms a step, idle share "
        f"{profiles['kernel']['idle_share']:.3f} / "
        f"{profiles['stock']['idle_share']:.3f} [{smi}]")
    n_params = nets["kernel"].num_params()
    del nets, lenet["nets"]
    torch.cuda.empty_cache()
    cnn = train_simplecnn(torch, impls, dev)
    cnn_times = mln_step_times(torch, {"kernel": cnn["nets"][0],
                                       "stock": cnn["nets"][1]},
                               cnn["ds"].migrate(dev), steps=10)
    cnn_prof = {side: _profile_steps(torch, net, cnn["ds"],
                                     LENET_PROFILE_STEPS)
                for side, net in zip(("kernel", "stock"), cnn["nets"])}
    log(f"[21] SimpleCNN train step at batch {SIMPLECNN_BATCH}: kernel "
        f"route {cnn_times['step_ms_kernel']:.3f} ms, stock "
        f"{cnn_times['step_ms_stock']:.3f} ms; device "
        f"{cnn_prof['kernel']['device_ms']:.3f} / "
        f"{cnn_prof['stock']['device_ms']:.3f} ms, idle share "
        f"{cnn_prof['kernel']['idle_share']:.3f} / "
        f"{cnn_prof['stock']['idle_share']:.3f} [{smi}]")
    steps = lenet["stats"]["kernel"]["steps"]
    n_eval = lenet["expected"] - steps
    rows = time_mln_kernels(torch, impls, Activation, F, dev,
                            (steps, n_eval, cnn["launches"]))
    for r in rows:
        log(f"[21] matmul_bias_act m={r['m']} k={r['k']} n={r['n']} "
            f"x{r['count']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms), plain {r['plain_ms']:.4f} ms, "
            f"F.linear + relu {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, FFMA), "
            f"{r['bound_tc_ms']:.4f} ms (3xTF32) [{smi}]")
    line = {
        "card": smi,
        "lenet": {
            "params": n_params,
            "train_examples": LENET_TRAIN["num_examples"],
            "test_examples": LENET_TEST["num_examples"],
            "batch": LENET_TRAIN["batch"], "epochs": LENET_EPOCHS,
            "lr": LENET_LR, "data_s": lenet["data_s"],
            "routes": lenet["stats"],
            "score_rel_err_first_steps": lenet["rel"],
            "scores_kernel_first": lenet["scores"]["kernel"][:LENET_COMPARE],
            "scores_stock_first": lenet["scores"]["stock"][:LENET_COMPARE],
            "matmul_bias_act_launches": lenet["launches"],
            "matmul_bias_act_expected": lenet["expected"],
            "step_times": times, "profile": profiles,
        },
        "zip": zip_out,
        "simplecnn": {
            "batch": SIMPLECNN_BATCH, "steps": SIMPLECNN_STEPS,
            "grad": cnn["grad"], "loss_rel_err": cnn["loss_rel_err"],
            "losses_kernel": cnn["losses_kernel"],
            "losses_stock": cnn["losses_stock"],
            "state_rel_err": cnn["state_rel_err"],
            "fold_max_abs_err": cnn["fold_max_abs_err"],
            "matmul_bias_act_launches": cnn["launches"],
            "step_times": cnn_times, "profile": cnn_prof,
        },
    }
    return line, rows


# ---------------------------------------------------------------------------
# [22]-[24] bf16-policy training, checkpoint resume, the s2d stem and the
# AttentionVertex
# ---------------------------------------------------------------------------

def non_f32(tree, path: str = "") -> list:
    """Names of every tensor of a nested dict that is not float32 (the
    bf16 policy keeps params, updater state and BN state float32)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in non_f32(v, f"{path}.{k}" if path else k)]
    return [] if str(tree.dtype) == "torch.float32" else [path]


def _check_f32(net, label):
    for name in ("params", "state", "opt_state"):
        bad = non_f32(getattr(net, name))
        if bad:
            raise AssertionError(f"[{label}] {name} not float32 under the "
                                 f"bf16 policy: {bad[:5]}")


def _bf16_trio(torch, dev, conf):
    """``conf`` under the bf16 policy on the kernel route, the same weights
    on the bf16 stock route, and on the float32 stock route."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net, ref = _conf_pair(torch, dev, dataclasses.replace(
        conf, compute_dtype="bfloat16"))
    f32 = ComputationGraph(dataclasses.replace(
        conf, use_kernels=False, compute_dtype=None),
        device=dev).set_params(net.params, net.state)
    return net, ref, f32


def _bits_equal(torch, a, b) -> bool:
    """Whether two nested dicts of tensors hold the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(torch, a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def s2d_stem_identity(torch, dev, seed: int = 4) -> dict:
    """[22] The s2d stem against the 7x7 stem: the same weights (the stem
    conv through ``stem_weights_to_s2d``), float32, ``use_kernels=False``,
    eval mode; the softmax within SERVED_TOL and the pooled features
    within FEATURE_RTOL of their largest magnitude."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    seven = ResNet50().init(device=dev)
    randomize_bn(seven, seed)
    s2d_zoo = ResNet50()
    s2d_zoo.stem_space_to_depth = True
    params = {k: dict(v) for k, v in seven.params.items()}
    w7 = seven.params["stem_conv"]["W"].permute(2, 3, 1, 0).cpu().numpy()
    w4 = ResNet50.stem_weights_to_s2d(w7)  # HWIO [4, 4, 12, 64]
    params["stem_conv"]["W"] = torch.from_numpy(w4).permute(3, 2, 0, 1)
    s2d = ComputationGraph(s2d_zoo.conf(), device=dev).set_params(
        params, seven.state)
    x = _synthetic_batch(ResNet50(), S2D_BATCH, seed).features
    outs, feats = [], []
    for net in (seven, s2d):
        outs.append(net.output(x))
        feats.append(net.feed_forward(x)["avgpool"])
    err = float(np.abs(outs[1] - outs[0]).max())
    ok = bool(np.all(np.abs(outs[1] - outs[0])
                     <= SERVED_TOL[0] + SERVED_TOL[1] * np.abs(outs[0])))
    feat_err = float(np.abs(feats[1] - feats[0]).max()
                     / np.abs(feats[0]).max())
    log(f"[22] s2d stem vs 7x7 stem (float32, eval, batch {S2D_BATCH}): "
        f"softmax max abs {err:.3e} (tol {SERVED_TOL}), pooled features "
        f"{feat_err:.3e} of their max (tol {FEATURE_RTOL})")
    if not (ok and feat_err <= FEATURE_RTOL):
        raise AssertionError(f"the s2d stem differs from the 7x7 stem: "
                             f"{err:.3e}, features {feat_err:.3e}")
    return {"batch": S2D_BATCH, "softmax_max_abs_err": err,
            "feature_rel_err": feat_err}


def gradient_check_on_card(torch, dev, seed: int = 5) -> dict:
    """[22] ``util.gradcheck`` on the card (its default device): a CNN with
    BN and a dense head through ``gradient_check``, the s2d stem's layers
    through ``check_layer_input_gradient``, all in float64 with the
    reference's defaults (epsilon 1e-6, max relative error 1e-5)."""
    from deeplearning4j_tpu_torch.conf import Activation, InputType
    from deeplearning4j_tpu_torch.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        BatchNormalization,
        ConvolutionLayer,
        SpaceToDepthLayer,
        ZeroPaddingLayer,
    )
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.conf.updaters import NoOp
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.util.gradcheck import (
        check_layer_input_gradient,
        gradient_check,
    )

    rng = np.random.default_rng(seed)
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(NoOp())
            .list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                    activation=Activation.TANH))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=4, activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(6, 6, 2)).build())
    ds = DataSet(rng.normal(size=(5, 6, 6, 2)),
                 np.eye(4)[rng.integers(0, 4, 5)])
    results = {"cnn_bn": gradient_check(conf, ds, device=dev)}
    for name, layer in (("space_to_depth", SpaceToDepthLayer(block_size=2)),
                        ("zero_padding",
                         ZeroPaddingLayer(padding=(1, 2, 1, 2)))):
        results[name] = check_layer_input_gradient(
            layer, InputType.convolutional(4, 4, 3),
            rng.normal(size=(2, 4, 4, 3)), device=dev)
    out = {k: {"passed": r.passed, "checked": r.n_checked,
               "max_rel_error": r.max_rel_error} for k, r in results.items()}
    log(f"[22] gradient check on {dev} (float64): {json.dumps(out)}")
    bad = {k: r.summary() for k, r in results.items() if not r.passed}
    if bad:
        raise AssertionError(f"[22] the gradient check fails on the card: "
                             f"{bad}")
    return out


def train_resnet50_bf16(torch, dev, seed: int = 2) -> dict:
    """[22] Full-width ResNet-50 (s2d stem, ``fused_conv_bn``) under the
    bf16 policy, trained by ``fit`` on the kernel route with a
    ``CheckpointListener``; launch counts over that fit alone; then the
    resume from the newest zip, bit for bit, and the kernel route against
    the stock route."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.optimize.checkpoint import (
        CheckpointListener,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    t0 = time.monotonic()
    zoo = ResNet50()
    zoo.stem_space_to_depth = True
    zoo.fused_conv_bn = True
    conf = zoo.conf()
    shapes = path_shapes(conf, BATCH)
    if len(shapes) != 36:
        raise AssertionError("the s2d graph's 1x1 sites are not ResNet-50's "
                             "36")
    net, ref, f32 = _bf16_trio(torch, dev, conf)
    condition_residual_bn(net)
    ref.set_params(net.params, net.state)
    f32.set_params(net.params, net.state)
    ds = _synthetic_batch(zoo, BATCH, seed)
    log(f"[22] ResNet-50 s2d stem + fused_conv_bn, compute_dtype bfloat16: "
        f"{net.num_params():,} params, batch {BATCH} "
        f"({time.monotonic() - t0:.1f} s to build)")
    trial = net.clone()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    # the resume is held bit for bit: cuDNN's deterministic algorithms for
    # both runs (the hand kernels sum without atomics)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tmp = tempfile.TemporaryDirectory()
    try:
        ckpt = CheckpointListener(tmp.name,
                                  save_every_n_iterations=CKPT_EVERY,
                                  keep_last=CKPT_KEEP)
        collect = CollectScoresListener()
        trial.set_listeners(collect, ckpt)

        # ---- the main path: counts from here on belong to it ----
        for k in (impls.matmul_stats, impls.matmul_bias_act, impls.probe):
            k.launches = 0
        t0 = time.monotonic()
        trial.fit(ListDataSetIterator([ds] * BF16_STEPS))
        torch.cuda.synchronize()
        launches = {"matmul_stats": impls.matmul_stats.launches,
                    "matmul_bias_act": impls.matmul_bias_act.launches,
                    "probe": impls.probe.launches}
        # ---- end of the main path ----
        fit_s = time.monotonic() - t0
        trial.set_listeners()
        losses = collect.scores
        log(f"[22] fit: {BF16_STEPS} steps in {fit_s:.1f} s (with "
            f"{len(ckpt.list_checkpoints())} zips kept), losses "
            f"{[round(v, 4) for v in losses]}; launches {launches}")
        if launches["matmul_stats"] != 36 * BF16_STEPS:
            raise AssertionError(
                f"matmul_stats launched {launches['matmul_stats']} times, "
                f"expected 36 per step = {36 * BF16_STEPS}")
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"the bf16 loss did not fall: {losses}")
        _check_f32(trial, "22")
        resume = check_resume(torch, dev, trial, ckpt, ds, losses)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        tmp.cleanup()
    del trial
    cmp = _compare_training(torch, net, ref, ds, COMPARE_STEPS, "22",
                            f32=f32)
    del f32
    _check_f32(net, "22")
    out_dtype = net.output(ds.features[:2]).dtype
    if out_dtype != np.float32:
        raise AssertionError(f"the bf16-policy output is {out_dtype}")
    log(f"[22] params, updater state and BN state float32 after training, "
        f"output {out_dtype}")
    return {"net": net, "ref": ref, "ds": ds, "launches": launches,
            "shapes": shapes, "losses": losses, "fit_s": fit_s,
            "resume": resume, **cmp}


def check_resume(torch, dev, trial, ckpt, ds, losses) -> dict:
    """[22] Retention left the newest CKPT_KEEP zips; the newest restored
    through ``load_checkpoint_graph`` and trained the remaining steps
    equals the uninterrupted run bit for bit (params, updater state, BN
    state, losses)."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    saved = [CKPT_EVERY * (i + 1) - 1
             for i in range(BF16_STEPS // CKPT_EVERY)]
    kept = [c.iteration for c in ckpt.list_checkpoints()]
    if kept != saved[-CKPT_KEEP:]:
        raise AssertionError(f"retention kept iterations {kept}, expected "
                             f"{saved[-CKPT_KEEP:]} of {saved}")
    if not all(ckpt.verify(c) for c in ckpt.list_checkpoints()):
        raise AssertionError("a kept checkpoint fails its digest")
    t0 = time.monotonic()
    resumed = ckpt.load_checkpoint_graph(device=dev)
    load_s = time.monotonic() - t0
    start = resumed.iteration
    collect = CollectScoresListener()
    resumed.set_listeners(collect)
    resumed.fit(ListDataSetIterator([ds] * (BF16_STEPS - start)))
    torch.cuda.synchronize()
    same = {name: _bits_equal(torch, getattr(resumed, name),
                              getattr(trial, name))
            for name in ("params", "opt_state", "state")}
    same["losses"] = collect.scores == losses[start:]
    size = os.path.getsize(os.path.join(ckpt.directory,
                                        ckpt.last_checkpoint().filename))
    log(f"[22] checkpoints at iterations {saved}, kept {kept}; resumed from "
        f"iteration {start} ({load_s:.1f} s to load a {size / 1e6:.1f} MB "
        f"zip), {BF16_STEPS - start} steps: bit for bit {same}")
    if not all(same.values()):
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {same}")
    return {"saved_iterations": saved, "kept_iterations": kept,
            "resumed_from": start, "zip_bytes": size, "load_s": load_s,
            "bit_for_bit": same}


def train_gpt2_bf16(torch, dev, f32_losses) -> dict:
    """[23] The GPT-2-small-width LM under the bf16 policy, trained by
    ``fit`` on the kernel route (launches over the fit alone), against the
    stock route and against [14]'s float32 losses on the same batch."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    n_layers, t = GEN_MODEL["n_layers"], GEN_MODEL["max_len"]
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=GEN_SEED, **GEN_MODEL)
    net, ref, f32 = _bf16_trio(torch, dev, zoo.conf())
    ds = lm_dataset(torch, dev, zoo.vocab_size, LM_BATCH, t, LM_SEED)
    trial = net.clone()

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
    track = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)]
    log(f"[23] LM bf16 fit: {LM_TRAIN_STEPS} steps in "
        f"{time.monotonic() - t0:.1f} s, losses "
        f"{[round(v, 4) for v in losses]} (float32 [14]: "
        f"{[round(v, 4) for v in f32_losses]}, relative "
        f"{[round(v, 4) for v in track]}, tol {BF16_TRACK_RTOL}); launches "
        f"{json.dumps(launches)}")
    for name, n in launches.items():
        if n != n_layers * LM_TRAIN_STEPS:
            raise AssertionError(f"{name} launched {n} times in bf16, "
                                 f"expected {n_layers * LM_TRAIN_STEPS}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the bf16 LM loss did not fall: {losses}")
    if len(track) != LM_TRAIN_STEPS or max(track) > BF16_TRACK_RTOL:
        raise AssertionError(f"the bf16 LM losses left the float32 run's: "
                             f"{losses} vs {f32_losses}")
    _check_f32(trial, "23")
    del trial
    cmp = _compare_lm(torch, att, net, ref, ds, COMPARE_STEPS, "23",
                      n_layers, f32=f32)
    del f32
    return {"net": net, "ref": ref, "ds": ds, "launches": launches,
            "losses": losses, "f32_losses": f32_losses,
            "track_rel_err": track, "compare": cmp}


def attention_vertex_graph(torch, dev, bf16: bool):
    """[24] One causal AttentionVertex (12 heads x 64, width 768) over an
    8 x 1024 sequence with a ragged key mask (a network input), into a
    16-class time-distributed softmax: the kernel and stock routes, and
    under the bf16 policy also the float32 stock route (:func:`_bf16_trio`)."""
    from deeplearning4j_tpu_torch.conf import Activation, InputType
    from deeplearning4j_tpu_torch.conf.graph import AttentionVertex
    from deeplearning4j_tpu_torch.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )

    e, t = GEN_MODEL["embed_dim"], GEN_MODEL["max_len"]
    conf = (NeuralNetConfiguration.builder().seed(GEN_SEED)
            .graph_builder()
            .add_inputs("x", "mask")
            .set_input_types(InputType.recurrent(e, timesteps=t),
                             InputType.feed_forward(t))
            .add_vertex("attn", AttentionVertex(
                n_out=e, n_heads=GEN_MODEL["n_heads"], causal=True),
                "x", "x", "x", "mask")
            .add_layer("output", OutputLayer(
                n_out=ATTN_VERTEX_CLASSES, activation=Activation.SOFTMAX),
                "attn")
            .set_outputs("output").build())
    if bf16:
        return _bf16_trio(torch, dev, conf)
    return _conf_pair(torch, dev, conf)


def train_attention_vertex(torch, dev) -> dict:
    """[24] The AttentionVertex graph trained 2 steps in float32 and 2 in
    bf16, each against the stock route; rows 6-8 launch once a forward and
    backward."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.ops import attention as att

    e, t = GEN_MODEL["embed_dim"], GEN_MODEL["max_len"]
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 3)
    x = torch.randn((LM_BATCH, t, e), generator=gen, device=dev)
    steps = torch.arange(t, device=dev)[None, :]
    mask = (steps < torch.tensor(LM_MASK_LENGTHS, device=dev)[:, None]
            ).float()
    y = torch.zeros((LM_BATCH, t, ATTN_VERTEX_CLASSES), device=dev)
    y.scatter_(2, torch.randint(0, ATTN_VERTEX_CLASSES, (LM_BATCH, t, 1),
                                generator=gen, device=dev), 1.0)
    mds = MultiDataSet(features=[x, mask], labels=[y])
    net, ref = attention_vertex_graph(torch, dev, False)
    cmp = _compare_lm(torch, att, net, ref, mds, 2, "24 float32", 1)
    log(f"[24 float32] AttentionVertex 12 x 64, 8 x {t}, ragged key mask: "
        f"step-1 gradients global L2 {cmp['grad']['global_l2']:.3e}, "
        f"losses {cmp['loss_rel_err']}; launches "
        f"{json.dumps(cmp['launches'])}")
    out = {"float32": {k: cmp[k] for k in (
        "grad", "loss_rel_err", "launches", "losses_kernel",
        "losses_stock")}}
    del net, ref
    net, ref, f32 = attention_vertex_graph(torch, dev, True)
    cmp = _compare_lm(torch, att, net, ref, mds, 2, "24 bfloat16", 1,
                      f32=f32)
    _check_f32(net, "24 bfloat16")
    log(f"[24 bfloat16] launches {json.dumps(cmp['launches'])}")
    out["bfloat16"] = {k: cmp[k] for k in (
        "grad", "loss_rel_err", "launches", "losses_kernel",
        "losses_stock", "losses_f32")}
    return out


def bf16_step_times(torch, models: dict, ds, steps: int, smi: str,
                    unit: int) -> dict:
    """ms per ``fit_batch`` step of each model in alternating turns
    (:func:`mln_step_times`), ``unit`` examples or tokens a step, and each
    bf16 route's device time and idle share under ``torch.profiler``."""
    times = mln_step_times(torch, models, ds, pairs=3, steps=steps)
    out = {"card": smi, "steps_per_turn": steps, "pairs": 3}
    for side in models:
        out[f"step_ms_{side}"] = times[f"step_ms_{side}"]
        out[f"per_s_{side}"] = unit / times[f"step_ms_{side}"] * 1e3
    for side in ("bf16_kernel", "bf16_stock"):
        prof = _profile_steps(torch, models[side], ds, 3)
        out[f"profile_{side}"] = prof
    return out


def resnet_bf16_step_times(torch, dev, trained, smi) -> dict:
    """[22] The bf16 ResNet-50 step per route beside the float32
    ``fused_conv_bn`` ResNet-50 of [7]-[8] (7x7 stem) per route."""
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    zoo = ResNet50()
    zoo.fused_conv_bn = True
    f32, f32_ref = _route_pair(torch, dev, zoo)
    condition_residual_bn(f32)
    models = {"bf16_kernel": trained["net"], "bf16_stock": trained["ref"],
              "f32_kernel": f32, "f32_stock": f32_ref}
    return bf16_step_times(torch, models, trained["ds"], 5, smi, BATCH)


def lm_bf16_step_times(torch, dev, trained, smi) -> dict:
    """[23] The bf16 LM step per route beside [15]'s float32 LM per
    route."""
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=GEN_SEED, **GEN_MODEL)
    f32, f32_ref = _route_pair(torch, dev, zoo)
    models = {"bf16_kernel": trained["net"], "bf16_stock": trained["ref"],
              "f32_kernel": f32, "f32_stock": f32_ref}
    return bf16_step_times(torch, models, trained["ds"], 2, smi,
                           LM_BATCH * GEN_MODEL["max_len"])


def bf16_matmul_bound_ms(m, k, n):
    """(operations ms, bytes ms) of row 2 in bf16: 2*M*N*K at the bf16
    tensor-core peak; x, w read and y written once in bf16, the two f32
    column vectors written once."""
    return (2.0 * m * n * k / PEAK_OPS_PER_S["bfloat16"] * 1e3,
            ((m * k + n * k + m * n) * 2 + 2 * n * 4)
            / HBM_BYTES_PER_S * 1e3)


def time_stats_bf16(torch, impls, F, dev, shapes) -> dict:
    """[22] Row 2 in bf16 at the training path's 36 sites: per shape the
    kernel (CUDA events and device time), its plain version, ``F.linear``
    and the stock composite in bf16, and the bf16 bound; summed over the
    36 sites of one step."""
    gen = torch.Generator(device=dev).manual_seed(97)
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    rows = []
    for (m, k, n), count in counts.items():
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        w = (torch.randn((n, k), generator=gen, device=dev)
             / math.sqrt(k)).bfloat16()
        got, ref = impls.matmul_stats(x, w), impls.matmul_stats_plain(x, w)
        ops_ms, bytes_ms = bf16_matmul_bound_ms(m, k, n)
        rows.append({
            "m": m, "k": k, "n": n, "count": count,
            "max_abs_err": float((got[0].float() - ref[0].float())
                                 .abs().max()),
            "ms": cuda_time_ms(lambda: impls.matmul_stats(x, w)),
            "device_ms": device_ms(lambda: impls.matmul_stats(x, w),
                                   ["stats_kernel"]),
            "plain_ms": cuda_time_ms(lambda: impls.matmul_stats_plain(x, w)),
            "library_ms": cuda_time_ms(lambda: F.linear(x, w)),
            "composite_ms": cuda_time_ms(lambda: stock_stats(F, x, w)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        del x, w, got, ref
    out = {key: _total(rows, key) for key in (
        "ms", "plain_ms", "library_ms", "composite_ms", "bound_ms")}
    out["device_ms"] = (_total(rows, "device_ms")
                        if all(r["device_ms"] for r in rows) else None)
    out["bound_by"] = max(("operations", "bytes"), key=lambda b: sum(
        r["count"] for r in rows if r["bound_by"] == b))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["shapes"] = rows
    return out


def time_attention_bf16(torch, F, att, dev) -> dict:
    """[23] Rows 6-8 in bf16 at the LM step's shape ([8, 12, 1024, 64],
    causal, no mask): each kernel (CUDA events and device time) beside its
    plain version, SDPA's forward and SDPA's backward (autograd through
    F.scaled_dot_product_attention) in bf16, and the bf16 bound."""
    gen = torch.Generator(device=dev).manual_seed(76)
    b, h, t, d = LM_BATCH, GEN_MODEL["n_heads"], GEN_MODEL["max_len"], \
        GEN_HEAD_DIM
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    sm = 1.0 / math.sqrt(d)
    o, l, m = att.flash_attention(q, k, v, None, True, return_stats=True)
    ops = att.bwd_operands(q, k, v, None, o, l, m, do)
    dq, di = att._flash_dq_cuda(*ops, True, sm)
    dk, dv = att._flash_dkv_cuda(*ops[:4], l, m, di, do, True, sm)
    plain_o = att.flash_attention_plain(q, k, v, None, True)[0]
    ref = att.flash_attention_bwd_plain(q, k, v, None, o, l, m, do, True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    lib_o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    bwd_plain_ms = cuda_time_ms(
        lambda: att.flash_attention_bwd_plain(q, k, v, None, o, l, m, do,
                                              True))
    bwd_lib_ms = cuda_time_ms(
        lambda: torch.autograd.grad(lib_o, leaves, do, retain_graph=True))
    pairs = 0.5 * b * h * t * t  # causal (query, key) pairs
    vec = b * h * t * 4  # one f32 [B, H, T] row vector
    tile = b * h * t * d * 2  # one bf16 [B, H, T, D] tensor
    out = {}
    for name, fn, got, want, products, nbytes, kern, plain_ms, lib_ms in (
            ("flash_attention",
             lambda: att.flash_attention(q, k, v, None, True), (o,),
             (plain_o,), 2, 4 * tile + 2 * vec, ["fwd_kernel"],
             cuda_time_ms(lambda: att.flash_attention_plain(q, k, v, None,
                                                            True)),
             cuda_time_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True))),
            ("flash_attention_bwd_dq",
             lambda: att._flash_dq_cuda(*ops, True, sm), (dq,), ref[:1], 3,
             6 * tile + 3 * vec, ["dq_kernel"], bwd_plain_ms, bwd_lib_ms),
            ("flash_attention_bwd_dkv",
             lambda: att._flash_dkv_cuda(*ops[:4], l, m, di, do, True, sm),
             (dk, dv), ref[1:], 4, 6 * tile + 3 * vec, ["dkv_kernel"],
             bwd_plain_ms, bwd_lib_ms)):
        ops_ms = products * 2.0 * pairs * d / PEAK_OPS_PER_S["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "b": b, "h": h, "t": t, "d": d,
            "max_abs_err": max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)),
            "ms": cuda_time_ms(fn), "device_ms": device_ms(fn, kern),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    return out


def bf16_training(torch, impls, F, att, dev, smi, f32_lm_losses) -> tuple:
    """Phases [22]-[24]; returns (the ``trained_bf16`` line, the bf16 rows
    of the kernels line by kernel name)."""
    s2d = s2d_stem_identity(torch, dev)
    gradcheck = gradient_check_on_card(torch, dev)
    torch.cuda.empty_cache()
    rn = train_resnet50_bf16(torch, dev)
    rn_times = resnet_bf16_step_times(torch, dev, rn, smi)
    stats = time_stats_bf16(torch, impls, F, dev, rn["shapes"])
    stats.update(launches=rn["launches"]["matmul_stats"],
                 scope=(f"one ResNet-50 training step at batch {BATCH} "
                        "under the bf16 policy: the 36 FusedConvBN1x1 "
                        "sites, bfloat16 operands, f32 sums; library = "
                        "F.linear in bf16 (composite: F.linear, then the "
                        "f32 column sums of y and y*y)"))
    log(f"[22] ResNet-50 bf16 step at batch {BATCH}: kernel route "
        f"{rn_times['step_ms_bf16_kernel']:.2f} ms, stock "
        f"{rn_times['step_ms_bf16_stock']:.2f} ms; float32 kernel "
        f"{rn_times['step_ms_f32_kernel']:.2f} ms, stock "
        f"{rn_times['step_ms_f32_stock']:.2f} ms; bf16 device "
        f"{rn_times['profile_bf16_kernel']['device_ms']:.2f} / "
        f"{rn_times['profile_bf16_stock']['device_ms']:.2f} ms, idle share "
        f"{rn_times['profile_bf16_kernel']['idle_share']:.3f} / "
        f"{rn_times['profile_bf16_stock']['idle_share']:.3f} [{smi}]")
    log(f"[22] matmul_stats bf16 per step (36 sites): kernel "
        f"{stats['ms']:.3f} ms (device {stats['device_ms']}), plain "
        f"{stats['plain_ms']:.3f}, F.linear {stats['library_ms']:.3f}, "
        f"composite {stats['composite_ms']:.3f}, bound "
        f"{stats['bound_ms']:.4f} ms ({stats['bound_by']}) [{smi}]")
    rn_line = {k: rn[k] for k in ("launches", "losses", "fit_s", "resume",
                                  "grad", "loss_rel_err", "state_rel_err",
                                  "losses_kernel", "losses_stock")}
    rn_line["step_times"] = rn_times
    del rn, rn_times
    torch.cuda.empty_cache()

    lm = train_gpt2_bf16(torch, dev, f32_lm_losses)
    lm_times = lm_bf16_step_times(torch, dev, lm, smi)
    attn = time_attention_bf16(torch, F, att, dev)
    for name, r in attn.items():
        r["launches"] = lm["launches"][name]
        r["scope"] = ("one launch (one layer's attention) of the LM "
                      "training step under the bf16 policy, 8 x 12 heads x "
                      "1024 x 64, causal; library = "
                      "F.scaled_dot_product_attention in bf16"
                      + (" (its backward by autograd: dq, dk and dv "
                         "together, as plain_ms)" if "bwd" in name else ""))
        log(f"[23] {name} bf16: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']}), plain {r['plain_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{smi}]")
    tokens = LM_BATCH * GEN_MODEL["max_len"]
    log(f"[23] LM bf16 step at {tokens} tokens: kernel route "
        f"{lm_times['step_ms_bf16_kernel']:.1f} ms "
        f"({lm_times['per_s_bf16_kernel']:.0f} tokens/s), stock "
        f"{lm_times['step_ms_bf16_stock']:.1f} ms; float32 kernel "
        f"{lm_times['step_ms_f32_kernel']:.1f} ms, stock "
        f"{lm_times['step_ms_f32_stock']:.1f} ms; bf16 device "
        f"{lm_times['profile_bf16_kernel']['device_ms']:.1f} / "
        f"{lm_times['profile_bf16_stock']['device_ms']:.1f} ms, idle share "
        f"{lm_times['profile_bf16_kernel']['idle_share']:.3f} / "
        f"{lm_times['profile_bf16_stock']['idle_share']:.3f} [{smi}]")
    lm_line = {k: lm[k] for k in ("launches", "losses", "f32_losses",
                                  "track_rel_err")}
    lm_line["compare"] = {k: lm["compare"][k] for k in (
        "grad", "loss_rel_err", "launches", "losses_kernel",
        "losses_stock")}
    lm_line["step_times"] = lm_times
    del lm, lm_times
    torch.cuda.empty_cache()

    vertex = train_attention_vertex(torch, dev)
    torch.cuda.empty_cache()
    line = {"card": smi, "s2d_stem": s2d, "gradient_check": gradcheck,
            "resnet50": rn_line,
            "lm": lm_line, "attention_vertex": vertex}
    return line, {"matmul_stats": stats, **attn}


# [25] the kernel registry and the per-shape tuner: every candidate tiling
# of every planned envelope against the kernel's plain version, at the
# tolerances above; the tuned routes against the stock routes as in [4],
# [17] and [11]; the tuning cache saved, bound and corrupted on the card.
# The bf16 training step's tuned-vs-default loss difference may be at most
# the bf16 stock route's own distance from float32 on the same batch: a
# tiling regroups the statistics' float32 partial sums, which bf16
# activations round into.
TUNE_CACHE = "deeplearning4j_tpu_torch/_build/tuning_cache_smoke.json"
# the kernels line's rows by the registry's kernel id (rows 7-8 and the
# probe keep their fixed tiles)
TUNED_ID = {"matmul_bias_act": "matmul_bias_act",
            "matmul_stats": "conv_bn_act",
            "matmul_bias_act_int8": "matmul_bias_act_int8",
            "flash_attention": "flash_attention",
            "paged_decode_attention": "paged_decode_attention"}
TUNE_SEED = 25


def _candidate_error(torch, kid, dtype, got, ref) -> tuple:
    """(error, holds) of one candidate's output against the plain
    version's, at the kernel's tolerance: KERNEL_TOL (row 1), stats_errors
    (row 2), INT8_MAX_ULP ulps (row 4), ATTN_TOL's o (row 6), DECODE_TOL
    (row 5)."""
    if kid == "conv_bn_act":
        errs, ok = stats_errors(torch, got, ref, dtype)
        return max(errs["y"], errs["plain_s"], errs["plain_q"]), ok
    if kid == "matmul_bias_act_int8":
        ulps = _ulps(torch, got, ref)
        return ulps, ulps <= INT8_MAX_ULP and bool(torch.isfinite(got).all())
    tol = {"matmul_bias_act": KERNEL_TOL[dtype],
           "flash_attention": ATTN_TOL[dtype]["o"],
           "paged_decode_attention": DECODE_TOL[dtype]}[kid]
    err, bad = _within(torch, got, ref, tol)
    return err, bad == 0 and bool(torch.isfinite(got.float()).all())


def _same_bits(torch, a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same_bits(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def check_candidates(torch, kernels, planned) -> dict:
    """[25] every candidate tiling of every planned envelope against the
    plain version on the same seeded inputs; the default must be a
    candidate, and every candidate's output is also compared bit for bit
    with the default's. A candidate whose launch is refused is logged and
    left out of the tuning (the tuner records it so too); a refused
    default fails the run."""
    out = {}
    for kid, env in planned:
        kernel = kernels.REGISTRY.get(kid)
        if not kernel.supports(env):
            raise AssertionError(f"[25] {kid} does not support its planned "
                                 f"envelope {env.key}")
        cands = kernel.candidates(env)
        default = tuple(kernel.default_tiling(env))
        if default not in cands:
            raise AssertionError(f"[25] {kid} {env.key}: default {default} "
                                 f"not among the candidates {cands}")
        args = kernel.make_inputs(env, seed=TUNE_SEED)
        ref = kernel.reference(env)(*args)
        base, rows = None, []
        for tiling in [default] + [c for c in cands if c != default]:
            try:
                got = kernel.build(env, tiling)(*args)
                torch.cuda.synchronize()
            except RuntimeError as e:
                if tiling == default:
                    raise
                rows.append({"tiling": list(tiling), "refused": str(e)})
                continue
            err, ok = _candidate_error(torch, kid, env.dtype, got, ref)
            if not ok:
                raise AssertionError(f"[25] {kid} {env.key} tiling {tiling}: "
                                     f"error {err} outside the tolerance")
            base = got if base is None else base
            rows.append({"tiling": list(tiling), "err": err,
                         "same_bits_as_default": _same_bits(torch, got,
                                                            base)})
        k = out.setdefault(kid, {"envelopes": 0, "candidates": 0,
                                 "refused": 0, "max_err": 0.0,
                                 "bit_identical_to_default": True})
        k["envelopes"] += 1
        k["candidates"] += len(cands)
        k["refused"] += sum("refused" in r for r in rows)
        k["max_err"] = max([k["max_err"]] + [r["err"] for r in rows
                                             if "err" in r])
        k["bit_identical_to_default"] &= all(
            r.get("same_bits_as_default", True) for r in rows)
        log(f"[25] {kid} {env.key}: default {list(default)}; "
            + "; ".join(f"{r['tiling']} " + (
                f"refused ({r['refused'][:80]})" if "refused" in r else
                f"err {r['err']:.3e}"
                f"{'' if r['same_bits_as_default'] else ' (other bits)'}")
                for r in rows))
        del args, ref, base
    return out


def check_refusals(torch, impls, att, dev) -> list:
    """[25] each tuned launcher refuses a tiling it does not take with
    cudaErrorInvalidValue, raised by its wrapper (the decode wrapper
    refuses a page over 64 before the launch)."""
    from deeplearning4j_tpu_torch.conf.activations import Activation

    gen = torch.Generator(device=dev).manual_seed(TUNE_SEED)
    x = torch.randn((64, 64), generator=gen, device=dev)
    b = torch.zeros((64,), device=dev)
    xq = torch.ones((8, 64), dtype=torch.int8, device=dev)
    wq = torch.ones((64, 64), dtype=torch.int8, device=dev)
    q = torch.randn((1, 2, 64, 64), generator=gen, device=dev)
    qd = torch.randn((1, 2, 64), generator=gen, device=dev)
    kc = torch.randn((1, 128, 2, 64), generator=gen, device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    act = Activation("identity")
    cases = {
        "matmul_bias_act (32, 64)": lambda: impls.matmul_bias_act(
            x, x, b, act, (32, 64)),
        "conv_bn_act (32,)": lambda: impls.matmul_stats(x, x, (32,)),
        "matmul_bias_act_int8 (5, 1)": lambda: impls.matmul_bias_act_int8(
            xq, wq, b + 1, b, act, (5, 1)),
        "matmul_bias_act_int8 (2, 3)": lambda: impls.matmul_bias_act_int8(
            xq, wq, b + 1, b, act, (2, 3)),
        "flash_attention (32, 32)": lambda: att.flash_attention(
            q, q, q, None, True, tiling=(32, 32)),
        "paged_decode_attention (128,)": lambda: att.paged_decode_attention(
            qd, kc, kc, pos, page=128),
    }
    refused = []
    for name, fn in cases.items():
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            refused.append(f"{name}: {e}")
            continue
        raise AssertionError(f"[25] {name} was launched")
    log("[25] illegal tilings refused: " + "; ".join(refused))
    return refused


def check_sentinels(torch, kernels, planned) -> list:
    """[25] each tuned launcher's argument 0 (the default rule) gives the
    bits of the registry's default tiling passed explicitly, at the first
    planned envelope of each kernel id."""
    from deeplearning4j_tpu_torch.ops import attention as att

    impls = kernels.impls
    seen = []
    for kid, env in planned:
        if kid in seen:
            continue
        seen.append(kid)
        kernel = kernels.REGISTRY.get(kid)
        args = kernel.make_inputs(env, seed=TUNE_SEED)
        explicit = kernel.build(env, kernel.default_tiling(env))(*args)
        if kid == "matmul_bias_act_int8":
            xq, wq, scale, b = args
            y = torch.empty_like(explicit)
            (m, k), n = xq.shape, wq.shape[1]
            rc = impls._int8_library().dl4j_matmul_bias_act_int8(
                xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, n, k, impls.ACTIVATION_IDS[env.act], 0,
                xq.device.index, impls.stream(xq))
            impls.raise_on_error(kid, rc)
        elif kid == "paged_decode_attention":
            y = att.paged_decode_attention(*args, page=0)
        elif kid == "flash_attention":
            y = att.flash_attention(*args[:3], *args[3:], causal=env.causal)
        elif kid == "conv_bn_act":
            y = impls.matmul_stats(*args)
        else:
            from deeplearning4j_tpu_torch.conf.activations import Activation

            y = impls.matmul_bias_act(*args, Activation(env.act))
        torch.cuda.synchronize()
        if not _same_bits(torch, y, explicit):
            raise AssertionError(f"[25] {kid} {env.key}: argument 0 differs "
                                 f"from the default tiling "
                                 f"{kernel.default_tiling(env)}")
    log(f"[25] argument 0 == the default tiling, bit for bit: {seen}")
    return seen


def _tuning_spy(tuner):
    """Collect every AutotuneResult the tuner returns, with the seconds
    each sweep took."""
    results = []
    real = tuner.autotune

    def spy(kernel, env, **kw):
        t0 = time.monotonic()
        res = real(kernel, env, **kw)
        res.seconds = time.monotonic() - t0
        results.append((kernel.kernel_id, env, res))
        return res

    tuner.autotune = spy
    return results, lambda: setattr(tuner, "autotune", real)


def tuning_report(results) -> dict:
    """Per kernel id: envelopes tuned, candidates timed, the default's and
    the winner's summed times, and how often the winner is not the
    default; each envelope logged."""
    out = {}
    for kid, env, res in results:
        d_ms = res.default_ms
        log(f"[25] tuned {kid} {env.key}: candidates "
            + ", ".join(f"{t['tiling']} "
                        + (f"{t['ms']:.4f} ms" if "ms" in t else "refused")
                        for t in res.trials)
            + f"; default {list(res.default)} "
            + (f"{d_ms:.4f} ms" if d_ms is not None else "refused")
            + f", winner {list(res.tiling)} {res.ms:.4f} ms")
        k = out.setdefault(kid, {"envelopes": 0, "candidates": 0,
                                 "default_ms": 0.0, "winner_ms": 0.0,
                                 "winner_not_default": 0, "per_envelope": []})
        k["envelopes"] += 1
        k["candidates"] += len(res.trials)
        k["default_ms"] += d_ms or 0.0
        k["winner_ms"] += res.ms
        k["winner_not_default"] += tuple(res.tiling) != tuple(res.default)
        k["per_envelope"].append({
            "env": env.key, "default": list(res.default), "default_ms": d_ms,
            "winner": list(res.tiling), "winner_ms": res.ms,
            "candidates": [t["tiling"] for t in res.trials]})
    return out


def _timed_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / reps * 1e3


def _tuning_models(torch, dev):
    """[25]'s models: ResNet-50 served (kernel and stock routes, one set of
    weights), the fused ResNet-50 train step in float32 and bf16 (kernel
    and stock routes each), the int8 AlexNet artifact (kernel and stock
    routes), and the GPT-2-small-width LM's kernel and stock decoders."""
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo.graphs import (
        ResNet50,
        TransformerEncoder,
    )
    from deeplearning4j_tpu_torch.zoo.models import AlexNet

    m = {}
    zoo = ResNet50()
    conf = dataclasses.replace(zoo.conf(), use_kernels=True)
    m["serve"] = ComputationGraph(conf, device=dev).init()
    randomize_bn(m["serve"], TUNE_SEED)
    m["serve_stock"] = ComputationGraph(
        dataclasses.replace(conf, use_kernels=False), device=dev).set_params(
        m["serve"].params, m["serve"].state)
    fused = ResNet50()
    fused.fused_conv_bn = True
    fconf = dataclasses.replace(fused.conf(), use_kernels=True)
    m["train"] = ComputationGraph(fconf, device=dev).init()
    condition_residual_bn(m["train"])
    p, s = m["train"].params, m["train"].state
    for name, cd, uk in (("train_stock", None, False),
                         ("train_bf16", "bfloat16", True),
                         ("train_bf16_stock", "bfloat16", False)):
        m[name] = ComputationGraph(dataclasses.replace(
            fconf, compute_dtype=cd, use_kernels=uk), device=dev).set_params(
            p, s)
    m["batch"] = _synthetic_batch(fused, BATCH, TUNE_SEED)
    alex = AlexNet()
    net = MultiLayerNetwork(dataclasses.replace(alex.conf(), use_kernels=True),
                            dev).init()
    rng = np.random.default_rng(TUNE_SEED)
    image = (alex.height, alex.width, alex.channels)
    cal = [rng.random((BATCH,) + image, np.float32)
           for _ in range(INT8_CAL_BATCHES)]
    m["int8"] = iopt.quantize_for_inference(net, iopt.calibrate(net, cal))
    m["int8_stock"] = MultiLayerNetwork(dataclasses.replace(
        m["int8"].conf, use_kernels=False), dev).set_params(
        m["int8"].params, m["int8"].state)
    m["int8_x"] = rng.random((BATCH,) + image, np.float32)
    m["serve_x"] = rng.random((BATCH, zoo.height, zoo.width, zoo.channels),
                              np.float32)
    lm = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                            seed=GEN_SEED, **GEN_MODEL)
    lm_net = lm.init(device=dev)
    dec_kw = {k: GEN_CONFIG[k] for k in ("max_batch", "kv_bucket_min",
                                         "prompt_bucket_min")}
    m["dec"] = TransformerDecoder(lm_net, max_len=lm.max_len, **dec_kw)
    m["dec_stock"] = TransformerDecoder(lm_net, max_len=lm.max_len, **dec_kw)
    m["dec_stock"].use_kernels = False
    m["prompts"] = gen_requests(GEN_REQUESTS, lm.vocab_size, GEN_SEED)
    return m


def _served(torch, m) -> dict:
    """The served outputs of one batch per model and their forward ms."""
    out = {"resnet50": m["serve"].output(m["serve_x"]),
           "alexnet_int8": m["int8"].output(m["int8_x"])}
    out["resnet50_ms"] = _timed_ms(torch, lambda: m["serve"].output(
        m["serve_x"]))
    out["alexnet_int8_ms"] = _timed_ms(torch, lambda: m["int8"].output(
        m["int8_x"]))
    return out


def _train_losses(m) -> dict:
    """One train-mode forward and backward per route: the fused sites'
    conv_bn_act selections at batch 32, float32 and bf16."""
    return {name: m[name].compute_gradient_and_score(m["batch"])[1]
            for name in ("train", "train_bf16")}


def _lm_run(torch, m, dec, autotune=False) -> tuple:
    """[11]'s greedy requests through one GenerationEngine (warmed over
    every bucket first; with ``autotune`` the warmup tunes the decoder):
    outputs, timing, and the decode step's ms from the engine's stats."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    with GenerationEngine(dec, GenerationConfig(**GEN_CONFIG)) as eng:
        warm = eng.warmup(autotune_kernels=autotune)
        outs, timing = _sweep(eng, m["prompts"], GEN_MAX_NEW)
        stats = eng.stats()
    steps = sum(stats["windows"].values()) * GEN_CONFIG["fused_steps"]
    timing["decode_step_ms"] = stats["decode_seconds"] / max(steps, 1) * 1e3
    return outs, timing, warm


def check_selected(kernels, telemetry, planned) -> dict:
    """Every planned envelope resolved a tuned winner (its registry
    selection is tuned, and ``dl4j_kernel_selected_total`` counts its
    shape bucket), and every envelope a route resolved since the last
    retune is a planned, tuned one."""
    epoch, memo = kernels.REGISTRY._selected
    resolved = {(kid, env): sel for (kid, env), sel in memo.items()
                if sel is not None}
    missing = [f"{kid} {env.key}" for kid, env in planned
               if not (kid, env) in resolved]
    untuned = [f"{kid} {env.key}" for (kid, env), sel in resolved.items()
               if not sel.tuned]
    unplanned = [f"{kid} {env.key}" for (kid, env) in resolved
                 if (kid, env) not in set(planned)]
    counted = [line for line in telemetry.prometheus_text().splitlines()
               if line.startswith("dl4j_kernel_selected_total{")]
    uncounted = [f"{kid} {env.shape_bucket}" for kid, env in planned
                 if not any(f'kernel="{kid}"' in line and
                            f'shape_bucket="{env.shape_bucket}"' in line
                            for line in counted)]
    if missing or untuned or unplanned or uncounted:
        raise AssertionError(
            f"[25] selections: planned but not resolved {missing[:5]}, "
            f"resolved untuned {untuned[:5]}, resolved unplanned "
            f"{unplanned[:5]}, not counted {uncounted[:5]}")
    return {"resolved": len(resolved), "planned": len(planned),
            "epoch": epoch}


def tune_phase(torch, dev, smi) -> tuple:
    """[25] the kernel registry, the tuner and the tuning cache on the
    card; returns the ``{"tuned": ...}`` line and the per-kernel summary
    the kernels line carries."""
    from deeplearning4j_tpu_torch import kernels, telemetry
    from deeplearning4j_tpu_torch.kernels import tuner
    from deeplearning4j_tpu_torch.ops import attention as att

    t_phase = time.monotonic()
    kernels.TUNING.clear()
    tag_before = kernels.cache_tag()
    check_refusals(torch, kernels.impls, att, dev)
    t0 = time.monotonic()
    m = _tuning_models(torch, dev)
    log(f"[25] models built in {time.monotonic() - t0:.1f} s")
    plans = {
        "resnet50_serve": kernels.plan_envelopes(m["serve"].conf, BATCH),
        "resnet50_train_f32": kernels.plan_envelopes(m["train"].conf, BATCH),
        "resnet50_train_bf16": kernels.plan_envelopes(m["train_bf16"].conf,
                                                      BATCH),
        "alexnet_int8": kernels.plan_envelopes(m["int8"].conf, BATCH),
        "lm_decoder": kernels.decoder_envelopes(m["dec"]),
    }
    planned = [pair for plan in plans.values() for pair in plan]
    log(f"[25] planned envelopes: "
        + json.dumps({k: len(v) for k, v in plans.items()})
        + f"; tag before tuning {tag_before}")

    # 1. every candidate of every planned envelope against the plain version
    t0 = time.monotonic()
    check_sentinels(torch, kernels, planned)
    checked = check_candidates(torch, kernels, planned)
    check_s = time.monotonic() - t0

    # 2. the default tilings (untuned): outputs and times for the record
    served_default = _served(torch, m)
    losses_default = _train_losses(m)
    losses_stock = {name: m[name].compute_gradient_and_score(m["batch"])[1]
                    for name in ("train_stock", "train_bf16_stock")}
    lm_default, lm_default_t, _ = _lm_run(torch, m, m["dec"])

    # 3. tune: autotune_model per model, the engine's warmup for the LM
    results, restore = _tuning_spy(tuner)
    try:
        t0 = time.monotonic()
        for name in ("serve", "train", "train_bf16", "int8"):
            kernels.autotune_model(m[name].conf, BATCH)
        models_s = time.monotonic() - t0
        telemetry.reset()
        t0 = time.monotonic()
        lm_tuned, lm_tuned_t, warm = _lm_run(torch, m, m["dec"],
                                             autotune=True)
        lm_s = time.monotonic() - t0
    finally:
        restore()
    tag_after = kernels.cache_tag()
    if tag_after == tag_before or warm["kernels"] != {
            "enabled": True, "tag": tag_after}:
        raise AssertionError(f"[25] tag {tag_before} -> {tag_after}, warmup "
                             f"reported {warm['kernels']}")
    tuned = tuning_report(results)
    tuned_envs = {(kid, env) for kid, env, _ in results}
    if tuned_envs != set(planned):
        raise AssertionError(f"[25] tuned {len(tuned_envs)} envelopes, "
                             f"planned {len(set(planned))}")

    # 4. the tuned routes against the stock routes
    served = _served(torch, m)
    losses = _train_losses(m)
    sel = check_selected(kernels, telemetry, planned)
    want = m["serve_stock"].output(m["serve_x"])
    np.testing.assert_allclose(served["resnet50"], want, rtol=SERVED_TOL[1],
                               atol=SERVED_TOL[0], err_msg="[25] ResNet-50")
    if not np.array_equal(served["resnet50"].argmax(-1), want.argmax(-1)):
        raise AssertionError("[25] ResNet-50: top-1 differs from stock")
    want8 = m["int8_stock"].output(m["int8_x"])
    ulps = _ulps(torch, torch.from_numpy(served["alexnet_int8"]),
                 torch.from_numpy(want8))
    if ulps > INT8_MAX_ULP:
        raise AssertionError(f"[25] int8 AlexNet: {ulps} ulps from stock")
    f32_rel = abs(losses["train"] - losses_stock["train_stock"]) / abs(
        losses_stock["train_stock"])
    if not f32_rel <= TRAIN_LOSS_RTOL[0]:
        raise AssertionError(f"[25] fused ResNet-50 f32 loss {f32_rel:.2e} "
                             f"from stock (tol {TRAIN_LOSS_RTOL[0]})")
    bf16_floor = abs(losses_stock["train_bf16_stock"]
                     - losses_stock["train_stock"])
    bf16_diff = abs(losses["train_bf16"] - losses_default["train_bf16"])
    if not (math.isfinite(losses["train_bf16"]) and bf16_diff <= bf16_floor):
        raise AssertionError(f"[25] bf16 loss tuned {losses['train_bf16']} "
                             f"vs default {losses_default['train_bf16']}: "
                             f"{bf16_diff:.3e} over the bf16 floor "
                             f"{bf16_floor:.3e}")
    seq = [m["dec"].generate(p, GEN_MAX_NEW) for p in m["prompts"]]
    lm_stock, _, _ = _lm_run(torch, m, m["dec_stock"])
    vs_seq = compare_streams(torch, m["dec"], lm_tuned, seq, m["prompts"],
                             "tuned engine vs sequential generate", "[25]")
    vs_stock = compare_streams(torch, m["dec_stock"], lm_tuned, lm_stock,
                               m["prompts"], "tuned vs use_kernels=False",
                               "[25]")
    same = {"resnet50": bool(np.array_equal(served["resnet50"],
                                            served_default["resnet50"])),
            "alexnet_int8": bool(np.array_equal(
                served["alexnet_int8"], served_default["alexnet_int8"])),
            "lm_streams": sum(a == b for a, b in zip(lm_tuned, lm_default)),
            "train_f32_loss": losses["train"] == losses_default["train"],
            "train_bf16_loss": (losses["train_bf16"]
                                == losses_default["train_bf16"])}
    log(f"[25] tuned routes vs stock: ResNet-50 within atol={SERVED_TOL[0]} "
        f"rtol={SERVED_TOL[1]}, top-1 equal; int8 AlexNet {ulps} ulp; fused "
        f"ResNet-50 loss f32 {f32_rel:.2e} relative, bf16 tuned vs default "
        f"{bf16_diff:.3e} (floor {bf16_floor:.3e}); LM streams vs sequential "
        f"{vs_seq['identical']}/{len(seq)} identical, vs stock "
        f"{vs_stock['identical']}/{len(seq)}; tuned vs default outputs the "
        f"same bits: {json.dumps(same)}; selections {json.dumps(sel)}")

    # 5. the cache on the card: saved, bound fresh, then corrupted
    path = os.path.abspath(TUNE_CACHE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    kernels.TUNING.bind(path, load=False)
    kernels.TUNING.save()
    fresh = kernels.KernelRegistry(kernels.TuningCache().bind(path))
    for kid in kernels.REGISTRY.ids():
        fresh.register(kernels.REGISTRY.get(kid))
    digests = {kid: kernels.tuning_digest(kid)
               for kid in kernels.REGISTRY.ids()}
    if {kid: fresh.tuning_digest(kid) for kid in digests} != digests \
            or fresh.cache_tag() != tag_after:
        raise AssertionError("[25] a fresh cache bound to the saved file "
                             "has other digests")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace('"ms"', '"ms_"', 1))
    try:
        kernels.set_tuning_cache(path)
        raise AssertionError("[25] the corrupted cache was accepted")
    except kernels.TuningCacheCorruptError as e:
        if path not in str(e):
            raise AssertionError(f"[25] the refusal does not name the file: "
                                 f"{e}") from e
        refusal = str(e)
    if kernels.TUNING.entries() != 0 or kernels.TUNING.path is not None:
        raise AssertionError("[25] the refused cache kept winners or a path")
    refused = _served(torch, m)
    for key in ("resnet50", "alexnet_int8"):
        if not np.array_equal(refused[key], served_default[key]):
            raise AssertionError(f"[25] after the refusal {key} differs from "
                                 f"its default-tiling output")
    refused_lm = [m["dec"].generate(p, GEN_MAX_NEW) for p in m["prompts"][:4]]
    compare_streams(torch, m["dec"], refused_lm, lm_default[:4],
                    m["prompts"][:4], "refused cache vs default tilings",
                    "[25]")
    os.remove(path)
    log(f"[25] cache: saved {len(text)} bytes, a fresh TuningCache bound to "
        f"it has the same digests {json.dumps(digests)}; corrupted: "
        f"{refusal}; the routes then run the default tilings (outputs the "
        f"default's bits, 4 LM streams held)")

    line = {
        "card": smi, "seconds": time.monotonic() - t_phase,
        "check_candidates_s": check_s, "tune_models_s": models_s,
        "tune_and_warm_lm_s": lm_s,
        "tuner_s": sum(r.seconds for _, _, r in results),
        "tag_before": tag_before, "tag_after": tag_after,
        "envelopes": {k: len(v) for k, v in plans.items()},
        "resnet50_forward_ms": {"default": served_default["resnet50_ms"],
                                "tuned": served["resnet50_ms"]},
        "alexnet_int8_forward_ms": {
            "default": served_default["alexnet_int8_ms"],
            "tuned": served["alexnet_int8_ms"]},
        "lm_tokens_per_s": {"default": lm_default_t["tokens_per_s"],
                            "tuned": lm_tuned_t["tokens_per_s"]},
        "lm_decode_step_ms": {"default": lm_default_t["decode_step_ms"],
                              "tuned": lm_tuned_t["decode_step_ms"]},
        "same_bits_as_default": same, "selections": sel,
        "checked": checked,
        "kernels": {kid: {k: v for k, v in row.items()
                          if k != "per_envelope"}
                    for kid, row in tuned.items()},
        "per_envelope": {kid: row["per_envelope"]
                         for kid, row in tuned.items()},
    }
    log(f"[25] ResNet-50 forward {line['resnet50_forward_ms']} ms, int8 "
        f"AlexNet forward {line['alexnet_int8_forward_ms']} ms, LM "
        f"{line['lm_tokens_per_s']} tokens/s, decode step "
        f"{line['lm_decode_step_ms']} ms (default / tuned; not gated); "
        f"the tuner's own {line['tuner_s']:.1f} s ({len(results)} "
        f"envelopes; models {line['tune_models_s']:.1f} s, LM tune + warmup "
        f"{line['tune_and_warm_lm_s']:.1f} s); phase "
        f"{line['seconds']:.1f} s [{smi}]")
    summary = {kid: {**line["kernels"][kid], **{
        f"checked_{k}": v for k, v in checked.get(kid, {}).items()}}
        for kid in line["kernels"]}
    return line, summary


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
    worst = check_matmul(torch, impls, Activation, dev,
                         sorted(set(shapes)) + list(MLN_SHAPES))

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

    # 19-20. the prefix cache and speculative decoding, on [11]'s model
    prefix_line, spec_line = decode_features(torch, F, att, dev, gen, fl, pd,
                                             smi)
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
    # 21. MultiLayerNetwork training
    mln_line, mln_rows = mln_training(torch, impls, Activation, F, dev, smi)
    mm = report["kernels"][0]
    mm["launches_mln"] = mln_line["lenet"]["matmul_bias_act_launches"][
        "kernel"]
    mm["mln_scope"] = (f"[21]: LeNet's dense 2450 -> 500 relu, "
                       f"{mln_rows[0]['count']} training steps at M 64 and "
                       f"{mln_rows[1]['count']} evaluation batches at M "
                       f"256, and SimpleCNN's 9216 -> 128 relu at M 32; "
                       f"library = F.linear then relu")
    mm["mln_shapes"] = mln_rows
    # 22-24. bf16-policy training, checkpoint resume, the AttentionVertex
    bf16_line, bf16_rows = bf16_training(torch, impls, F, att, dev, smi,
                                         lm_line["losses"])
    for row in report["kernels"]:
        if row["name"] in bf16_rows:
            row["bf16_training"] = bf16_rows[row["name"]]
    for row in report["kernels"]:
        source, prefixes = PTXAS_OF[row["name"]]
        row["ptxas"] = [r for prefix in prefixes
                        for r in ptxas_rows(ptxas, source, prefix)]
    # row 4's registers and spills by kernel variant, as the others' ptxas
    q8["registers"] = {r["kernel"]: r["registers"] for r in q8["ptxas"]}
    q8["spills"] = {r["kernel"]: r["spill_stores"] + r["spill_loads"]
                    for r in q8["ptxas"]}
    # 25. the kernel registry, the per-shape tuner and its cache (last: the
    # earlier phases run the default tilings)
    torch.cuda.empty_cache()
    tuned_line, tuned_rows = tune_phase(torch, dev, smi)
    for row in report["kernels"]:
        kid = TUNED_ID.get(row["name"])
        if kid in tuned_rows:
            row["tuning"] = tuned_rows[kid]
    # 26. data-parallel training through ParallelWrapper.fit: its ranks are
    # processes of their own on the kernels built in [2]
    torch.cuda.empty_cache()
    import chip_data_parallel

    dp_line, dp_row = chip_data_parallel.data_parallel_phase(torch, smi)
    for row in report["kernels"]:
        if row["name"] == "matmul_stats":
            row["data_parallel"] = dp_row
    # 27-28. the sequence layers: TextGenerationLSTM trained with tBPTT and
    # sampled; LearnedSelfAttentionLayer on rows 6-8
    torch.cuda.empty_cache()
    import chip_sequence

    text_line = chip_sequence.text_generation(torch, dev, smi)
    seq_line, seq_rows = chip_sequence.sequence_attention(torch, F, att, dev,
                                                          smi)
    for row in report["kernels"]:
        if row["name"] in seq_rows:
            row["seq_attention"] = {
                "scope": ("[28]: LearnedSelfAttentionLayer's core, float32, "
                          "32 x 4 heads x Tq (8 queries; 1) x 64 against "
                          "512 keys, non-causal, ragged key mask; library "
                          "= masked F.scaled_dot_product_attention (its "
                          "autograd, dq, dk and dv together, for rows 7-8)"),
                "shapes": seq_rows[row["name"]]}
    # 29. the multi-tenant serving platform: three full-width tenants on
    # their kernels behind InferenceServer(platform)
    torch.cuda.empty_cache()
    import chip_platform

    plat_line, plat_rows = chip_platform.platform_phase(torch, dev, smi)
    for row in report["kernels"]:
        if row["name"] in plat_rows:
            row["platform"] = plat_rows[row["name"]]
    # 30. the rest of the graph zoo at full width, row 1 at every routed site
    torch.cuda.empty_cache()
    import chip_zoo

    zoo_line, report["kernels"][0]["zoo"] = chip_zoo.zoo_phase(torch, F, dev,
                                                               smi)
    # 31. the rest of the layer DSL: every new layer card against CPU,
    # MobileNet-v1 served and C3D trained on row 1
    torch.cuda.empty_cache()
    import chip_layers

    layers_line, report["kernels"][0]["layers"] = \
        chip_layers.layers_dsl_phase(torch, F, dev, smi)
    # 32. the MoE transformer on rows 6-8: one rank, then experts across
    # ranks of their own
    torch.cuda.empty_cache()
    import chip_moe

    moe_line, moe_rows = chip_moe.moe_phase(torch, dev, smi)
    for row in report["kernels"]:
        if row["name"] in moe_rows:
            row["moe"] = moe_rows[row["name"]]
    # 33. a pretrained AlexNet fine-tuned on row 1 under the health layer
    torch.cuda.empty_cache()
    import chip_transfer

    transfer_line, report["kernels"][0]["transfer"] = \
        chip_transfer.transfer_phase(torch, F, dev, smi)
    # 34. preemption-safe, monitored training: the NaN-keeping split on
    # rows 1, 2, 6-8, ResNet-50 sessions and pod snapshots on row 2, the
    # guard modes across ranks, the UI, the legacy solvers on row 1
    torch.cuda.empty_cache()
    import chip_session

    impls.matmul_stats.launches = 0
    session_line = chip_session.session_phase(torch, dev, smi)
    for row in report["kernels"]:
        if row["name"] == "matmul_stats":
            row["session"] = {
                "launches_per_step": session_line["session"]["rank"][
                    "row2_launches_per_step"],
                "scope": ("[34b]: full-width ResNet-50 fused_conv_bn under "
                          "TrainingSession(ParallelWrapper exact) at one "
                          "NCCL rank, batch 32")}
        if row["name"] in ("matmul_bias_act", "matmul_stats",
                           "flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"):
            row["nan_inf_kept"] = True  # [34a] holds it
    log(json.dumps({"session": session_line}))
    log(json.dumps({"transfer": transfer_line}))
    log(json.dumps({"layers": layers_line}))
    log(json.dumps({"moe": moe_line}))
    log(json.dumps({"zoo": zoo_line}))
    log(json.dumps({"platform": plat_line}))
    log(json.dumps({"trained_text_lstm": text_line}))
    log(json.dumps({"sequence_attention": seq_line}))
    log(json.dumps({"trained_mln": mln_line}))
    log(json.dumps({"trained_bf16": bf16_line}))
    log(json.dumps(report))
    log(json.dumps({"served": served_line}))
    log(json.dumps({"trained": train_line}))
    log(json.dumps({"generated": gen_line}))
    log(json.dumps({"trained_lm": lm_line}))
    log(json.dumps({"served_int8": int8_line}))
    log(json.dumps({"prefix_cached": prefix_line}))
    log(json.dumps({"speculative": spec_line}))
    log(json.dumps({"tuned": tuned_line}))
    log(json.dumps({"data_parallel": dp_line}))
    log(f"[34] total wall time of the script {time.monotonic() - t_start:.1f}"
        f" s")
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
