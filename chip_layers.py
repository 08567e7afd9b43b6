#!/usr/bin/env python3
"""Phase [31] of ``chip_smoke.py``: the rest of the layer DSL
(``conf/layers_extra.py``) on one H100, with MobileNet-v1 served and C3D
trained on row 1 (``matmul_bias_act``).

- (a) Every ``layers_extra`` layer on ``cuda:0`` against the port on the
  CPU, float32 with TF32 off, seeded: the forward and the gradients of
  ``sum(y * r)`` with respect to the input and the params, each by its
  relative L2 within ``LAYER_REL_L2`` (cuDNN's and the CPU's float32 sums
  in other orders); ``Convolution3D`` 8x16x56x56x64 -> 64, k 3, SAME;
  ``Subsampling3DLayer`` MAX / AVG / SUM / PNORM, TRUNCATE and SAME, at
  odd sizes; ``DepthwiseConvolution2D`` 8x112x112x32, multiplier 1 and 2,
  stride 2 at an odd size; ``LocallyConnected2D`` 8x14x14x64 -> 64, k 3;
  ``LocallyConnected1D`` 8x128x64 -> 64, k 3; the 1-D / 3-D padding,
  cropping and upsampling layers, ``PReLULayer``,
  ``ElementWiseMultiplicationLayer``, ``Permute`` (an image and a
  sequence), ``RepeatVector`` and ``MaskLayer`` with a ragged mask. Each
  layer's forward ms on the card (CUDA events) is reported.
- (b) MobileNet-v1 (Howard et al. 2017, Table 1: 224x224x3, width
  multiplier 1.0, 1000 classes) as a ``ComputationGraph`` of
  ``ConvolutionLayer``, ``DepthwiseConvolution2D``, ``BatchNormalization``
  (seeded affines, running statistics those of a seeded batch),
  ``ActivationLayer(RELU)``, ``GlobalPoolingLayer(AVG)`` and
  ``OutputLayer``, batch 8, ``use_kernels=True`` against ``False`` on the
  same params. Gates: the logits' relative L2 within ``MOBILENET_REL_L2``
  and, with row 1's operands rounded to TF32 (``chip_zoo.one_pass_row1``),
  outside it; row 1's launches over two forwards, by (M, K, N,
  activation), twice ``kernels.routed_sites``' (the 13 pointwise convs).
  Reported: forward ms a route, images/s, peak memory.
- (c) C3D (Tran et al. 2015, Fig. 3: 16x112x112x3 clips, conv1a 64,
  conv2a 128, conv3a/b 256, conv4a/b 512, conv5a/b 512, all 3x3x3 SAME;
  pool1 1x2x2, the rest 2x2x2, pool5 SAME so that fc6 reads 1x4x4x512 =
  8192; fc6 / fc7 4096; 487 classes) as a ``MultiLayerNetwork``, batch 8,
  SGD(1e-5), 3 ``fit`` steps on each route from the same params. Gates:
  step-1 gradients and the losses at [7]'s limits, how far the params
  moved in step 1 by relative L2 within ``C3D_PARAM_REL_L2`` and, with
  row 1's operands rounded to TF32, outside it; row 1 launched twice
  a step (fc6 and fc7; its VJP runs the stock products) over the kernel
  route's fit alone, as ``routed_sites`` predicts; every 3-D conv's
  params moved on the kernel route. Reported: step ms a route, peak
  memory.
- (d) Row 1 at fc6 (8, 8192, 4096), fc7 (8, 4096, 4096) and MobileNet's
  first (100352, 32, 64) and last (392, 1024, 1024) pointwise convs, each
  against its plain version and timed beside ``F.linear`` + the
  activation and the bounds (``chip_zoo.time_zoo_shapes``); launches are
  those counted in (b) and (c).

``python3 chip_layers.py`` builds the kernels and runs [31] alone;
``python3 chip_layers.py --spread N`` instead reads (a)'s errors and (b)'s
and (c)'s route errors at N seeds, the readings the limits are set from.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np

import chip_smoke as cs

LAYER_SEED = 31
# card against CPU, relative L2 (float32 both, TF32 off): the forward
# sums at most 3*3*3*64 terms a cuDNN / oneDNN output in other orders, the
# gradients' weight sums up to 8*16*56*56 terms (``--spread 3`` on an H100
# 80GB HBM3 at 700 W: at most 9.3e-7 forward and 6.2e-6 gradients)
LAYER_REL_L2 = {"forward": 1e-5, "grad": 1e-4}
MOBILENET_BATCH = 8
MOBILENET_HW = 224
C3D_BATCH = 8
C3D_CLIP = (16, 112, 112)  # frames, height, width
C3D_FC6_IN = 8192  # pool5's 1x4x4x512
C3D_STEPS = 3
C3D_CLASSES = 487
# SGD's rate (Tran et al.'s is 0.003): on one repeated random batch a
# random net's loss falls by nats a step (13.8, 8.1, 4.8 at 1e-4 on an
# H100), and the routes' moves over 3 steps part by 3e-3..9e-3 relative
# at 1e-4 and 2e-4..4e-3 at 1e-5, from 6e-7 in the step-1 gradients and
# differently from run to run: so the params are held after step 1, and
# the later steps by their losses
C3D_LR = 1e-5
C3D_FLATTEN = 13  # the preprocessor's index: the 3-D layers come before it
# kernel route against stock, set from --spread readings (PERF.md): the
# logits' relative L2, and how far C3D's params moved in its 3 SGD steps
# (``--spread 3`` on an H100 80GB HBM3 at 700 W, seeds 31-33: logits
# 6.0e-5 to 8.0e-5 against 8.3e-3 to 9.5e-3 with one TF32 product a term;
# C3D's moves in step 1 1.5e-5 to 2.3e-5 against 3.0e-3 to 1.5e-2)
MOBILENET_REL_L2 = 8e-4
C3D_PARAM_REL_L2 = 2.5e-4
MOBILENET_BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
                    (2, 512), (1, 512), (1, 512), (1, 512), (1, 512),
                    (1, 512), (2, 1024), (1, 1024))


def _log(msg: str) -> None:
    cs.log(msg)


def _rel_l2(a, b) -> float:
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / max(den, 1e-300)


# --------------------------------------------------------------------------
# (a) every layer, card against CPU
# --------------------------------------------------------------------------

def layer_cases():
    """(label, layer, port input type, port input shape, with a mask)."""
    from deeplearning4j_tpu_torch.conf import layers_extra as px
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.inputs import InputType as IT
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionMode,
        PoolingType,
    )

    same, trunc = ConvolutionMode.SAME, ConvolutionMode.TRUNCATE
    vol = IT.convolutional_3d(15, 27, 27, 32)
    # smooth activations: a ReLU input within rounding of 0 takes the other
    # side on the other device and moves a gradient by O(1) (2-3 such of
    # 25.7M outputs read 3e-4 relative on the conv's gradients)
    cases = [("Convolution3D 8x16x56x56x64 k3 SAME",
              px.Convolution3D(n_out=64, kernel_size=(3, 3, 3),
                               activation=Activation.TANH),
              IT.convolutional_3d(16, 56, 56, 64), (8, 64, 16, 56, 56),
              False)]
    for pt in PoolingType:
        for mode in (trunc, same):
            cases.append((
                f"Subsampling3DLayer {pt.name} {mode.name} 8x15x27x27x32 "
                f"k3 s2", px.Subsampling3DLayer(
                    pooling_type=pt, kernel_size=(3, 3, 3), stride=(2, 2, 2),
                    convolution_mode=mode, pnorm=2),
                vol, (8, 32, 15, 27, 27), False))
    for mult, stride, hw in ((1, 1, 112), (2, 1, 112), (1, 2, 111),
                             (2, 2, 111)):
        cases.append((
            f"DepthwiseConvolution2D 8x{hw}x{hw}x32 mult {mult} s{stride}",
            px.DepthwiseConvolution2D(depth_multiplier=mult,
                                      stride=(stride, stride)),
            IT.convolutional(hw, hw, 32), (8, 32, hw, hw), False))
    seq = IT.recurrent(64, timesteps=128)
    cases += [
        ("LocallyConnected2D 8x14x14x64 -> 64 k3",
         px.LocallyConnected2D(n_out=64, kernel_size=(3, 3),
                               activation=Activation.TANH),
         IT.convolutional(14, 14, 64), (8, 64, 14, 14), False),
        ("LocallyConnected1D 8x128x64 -> 64 k3",
         px.LocallyConnected1D(n_out=64, kernel_size=3,
                               activation=Activation.TANH),
         seq, (8, 128, 64), False),
        ("Upsampling3D 2x2x2", px.Upsampling3D(), vol, (8, 32, 15, 27, 27),
         False),
        ("Cropping3D", px.Cropping3D(cropping=(1, 2, 0, 3, 2, 1)), vol,
         (8, 32, 15, 27, 27), False),
        ("ZeroPadding3DLayer", px.ZeroPadding3DLayer(
            padding=(1, 2, 0, 3, 2, 1)), vol, (8, 32, 15, 27, 27), False),
        ("Subsampling1DLayer MAX SAME k3 s2", px.Subsampling1DLayer(
            kernel_size=3, stride=2, convolution_mode=same), seq,
         (8, 128, 64), False),
        ("Upsampling1D 3", px.Upsampling1D(size=3), seq, (8, 128, 64),
         False),
        ("Cropping1D", px.Cropping1D(cropping=(3, 2)), seq, (8, 128, 64),
         False),
        ("ZeroPadding1DLayer", px.ZeroPadding1DLayer(padding=(2, 3)), seq,
         (8, 128, 64), False),
        ("PReLULayer image", px.PReLULayer(), IT.convolutional(56, 56, 64),
         (8, 64, 56, 56), False),
        ("PReLULayer volume", px.PReLULayer(), vol, (8, 32, 15, 27, 27),
         False),
        ("PReLULayer sequence", px.PReLULayer(), seq, (8, 128, 64), False),
        ("ElementWiseMultiplicationLayer", px.ElementWiseMultiplicationLayer(
            activation=Activation.TANH), seq, (8, 128, 64), False),
        ("Permute image (3, 1, 2)", px.Permute(dims=(3, 1, 2)),
         IT.convolutional(56, 48, 64), (8, 64, 56, 48), False),
        ("Permute sequence (2, 1)", px.Permute(dims=(2, 1)), seq,
         (8, 128, 64), False),
        ("RepeatVector 16", px.RepeatVector(repetition_factor=16),
         IT.feed_forward(1024), (8, 1024), False),
        ("MaskLayer ragged", px.MaskLayer(), seq, (8, 128, 64), True),
    ]
    return cases


def _layout(torch, t):
    if t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    if t.ndim == 5:
        return t.contiguous(memory_format=torch.channels_last_3d)
    return t.contiguous()


def _run_layer(torch, layer, params, x, r, mask):
    """Forward of ``layer`` and the gradients of ``sum(y * r)`` by input
    and param."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    xx = x.detach().clone().requires_grad_()
    kw = {} if mask is None else {"mask": mask}
    y, _ = layer.forward(leaves, {}, xx, **kw)
    (y * r).sum().backward()
    return y.detach(), xx.grad, {k: v.grad for k, v in leaves.items()}


def check_layer(torch, dev, case, seed=LAYER_SEED):
    """(a) one layer: errors card against CPU and the card's forward ms."""
    label, layer, itype, shape, masked = case
    gen = torch.Generator().manual_seed(seed)
    params = {k: _layout(torch, v)
              for k, v in layer.init(gen, itype).items()}
    x = _layout(torch, torch.randn(shape, generator=gen))
    mask = None
    if masked:
        lengths = torch.randint(1, shape[1] + 1, (shape[0],), generator=gen)
        mask = (torch.arange(shape[1])[None, :]
                < lengths[:, None]).float()
    with torch.no_grad():
        y_shape = layer.forward(params, {}, x, **(
            {} if mask is None else {"mask": mask}))[0].shape
    r = torch.randn(y_shape, generator=gen)
    cpu = _run_layer(torch, layer, params, x, r, mask)
    on = lambda t: None if t is None else _layout(torch, t.to(dev))  # noqa
    gp = {k: on(v) for k, v in params.items()}
    card = _run_layer(torch, layer, gp, on(x), on(r), on(mask))
    torch.cuda.synchronize()
    err = {"forward": _rel_l2(card[0], cpu[0]),
           "grad_x": _rel_l2(card[1], cpu[1])}
    for k in params:
        err[f"grad_{k}"] = _rel_l2(card[2][k], cpu[2][k])
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (card[0], card[1], *card[2].values()))
    xg, mg = on(x), on(mask)
    kw = {} if mg is None else {"mask": mg}
    with torch.no_grad():
        ms = cs.cuda_time_ms(lambda: layer.forward(gp, {}, xg, **kw))
    return {"layer": label, "shape": list(shape),
            "output": list(card[0].shape), "errors": err,
            "finite": finite, "forward_ms": ms}


def layers_phase(torch, dev, smi) -> list:
    """(a) every layer; raises when one is off."""
    rows = []
    for case in layer_cases():
        row = check_layer(torch, dev, case)
        rows.append(row)
        err = row["errors"]
        grads = {k: v for k, v in err.items() if k != "forward"}
        shown = {k: float(f"{v:.2e}") for k, v in grads.items()}
        _log(f"[31a] {row['layer']}: output {row['output']}, card vs CPU "
             f"forward {err['forward']:.2e}, gradients {json.dumps(shown)}"
             f" (tol {LAYER_REL_L2}); forward {row['forward_ms']:.4f} ms "
             f"[{smi}]")
        if not (row["finite"] and err["forward"] <= LAYER_REL_L2["forward"]
                and max(grads.values(), default=0.0)
                <= LAYER_REL_L2["grad"]):
            raise AssertionError(f"[31a] {row['layer']}: card vs CPU "
                                 f"{err} (tol {LAYER_REL_L2}), finite "
                                 f"{row['finite']}")
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# (b) MobileNet-v1 served
# --------------------------------------------------------------------------

def mobilenet_conf(seed=LAYER_SEED):
    """MobileNet-v1 at width 1.0 on 224x224x3, 1000 classes: a 3x3/2
    convolution, 13 depthwise-separable blocks (depthwise 3x3, BN, ReLU,
    pointwise 1x1, BN, ReLU; the table's last depthwise at stride 1, as
    its 7x7 input and output have it), average pooling and the softmax
    classifier."""
    from deeplearning4j_tpu_torch.conf import layers_extra as px
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers import (
        ActivationLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        BatchNormalization,
        ConvolutionLayer,
        ConvolutionMode,
        GlobalPoolingLayer,
        PoolingType,
    )
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.conf.weights import WeightInit

    g = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Sgd(learning_rate=0.01)).weight_init(WeightInit.RELU)
         .use_kernels(True).graph_builder().add_inputs("input")
         .set_input_types(InputType.convolutional(MOBILENET_HW,
                                                  MOBILENET_HW, 3)))

    def conv_bn(name, src, layer):
        g.add_layer(name, layer, src)
        g.add_layer(f"{name}_bn", BatchNormalization(), name)
        g.add_layer(f"{name}_relu", ActivationLayer(
            activation=Activation.RELU), f"{name}_bn")
        return f"{name}_relu"

    h = conv_bn("conv0", "input", ConvolutionLayer(
        n_out=32, kernel_size=(3, 3), stride=(2, 2), has_bias=False,
        convolution_mode=ConvolutionMode.SAME))
    for i, (stride, n_out) in enumerate(MOBILENET_BLOCKS):
        h = conv_bn(f"dw{i + 1}", h, px.DepthwiseConvolution2D(
            kernel_size=(3, 3), stride=(stride, stride), has_bias=False))
        h = conv_bn(f"pw{i + 1}", h, ConvolutionLayer(
            n_out=n_out, kernel_size=(1, 1), has_bias=False,
            convolution_mode=ConvolutionMode.SAME))
    g.add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), h)
    g.add_layer("output", OutputLayer(n_out=1000,
                                      activation=Activation.SOFTMAX), "pool")
    g.set_outputs("output")
    return g.build()


def mobilenet_pair(torch, dev, seed=LAYER_SEED) -> dict:
    import chip_zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = mobilenet_conf(seed)
    net = ComputationGraph(conf, device=dev).init()
    cs.randomize_bn(net, seed)
    rng = np.random.default_rng(seed)
    x_cal, x = (rng.random((MOBILENET_BATCH, MOBILENET_HW, MOBILENET_HW, 3),
                           np.float32)
                for _ in range(2))
    chip_zoo.calibrate_bn(torch, net, x_cal)
    ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                           device=dev).set_params(net.params, net.state)
    return {"conf": conf, "net": net, "ref": ref, "x": x}


def serve_mobilenet(torch, dev, smi) -> dict:
    """(b) MobileNet-v1 on both routes."""
    import chip_zoo
    from deeplearning4j_tpu_torch.kernels import impls, routing

    pair = mobilenet_pair(torch, dev)
    conf, net, ref, x = pair["conf"], pair["net"], pair["ref"], pair["x"]
    sites = routing.routed_sites(conf, MOBILENET_BATCH, mode="cuda")
    want = {}
    for _, _, e in sites:
        key = (e.m, e.k, e.n, e.act)
        want[key] = want.get(key, 0) + 2

    # ---- the main path: counts from here on belong to it ----
    cs.reset_launch_counts()
    z = chip_zoo.logits(torch, net, x)
    out = net.output(x)
    torch.cuda.synchronize()
    launches = cs.launch_counts()["matmul_bias_act"]
    by_shape = dict(impls.matmul_bias_act.shapes)
    # ---- end of the main path ----
    if len(sites) != len(MOBILENET_BLOCKS) or launches != 2 * len(sites) \
            or by_shape != want:
        raise AssertionError(f"[31b] matmul_bias_act launched {launches} "
                             f"times over 2 forwards, by shape {by_shape}; "
                             f"expected {want} ({len(sites)} routed sites)")
    z_ref = chip_zoo.logits(torch, ref, x)
    rel = chip_zoo._rel_l2(torch, z, z_ref)
    rel_one_pass = chip_zoo.one_pass_rel(torch, pair, z_ref)
    if not (math.isfinite(rel) and rel <= MOBILENET_REL_L2 < rel_one_pass):
        raise AssertionError(f"[31b] logits differ by relative L2 {rel:.3e},"
                             f" {rel_one_pass:.3e} with one TF32 product a "
                             f"term (tol {MOBILENET_REL_L2}: the first "
                             f"within, the second outside)")
    out_ref = ref.output(x)
    if out.shape != (MOBILENET_BATCH, 1000) or not np.isfinite(out).all() \
            or out_ref.shape != out.shape:
        raise AssertionError(f"[31b] output shape {out.shape}, or "
                             f"non-finite")
    row = {"params": net.num_params(), "routed_sites": len(sites),
           "launches": launches, "by_shape": {str(k): v for k, v in
                                              by_shape.items()},
           "logit_rel_l2": rel, "logit_rel_l2_one_pass": rel_one_pass,
           "logit_tol": MOBILENET_REL_L2,
           "forward_ms_kernel": chip_zoo._forward_ms(torch, net, x),
           "forward_ms_stock": chip_zoo._forward_ms(torch, ref, x),
           "peak_mib_kernel": chip_zoo._peak_mib(torch, net, x),
           "peak_mib_stock": chip_zoo._peak_mib(torch, ref, x)}
    for route in ("kernel", "stock"):
        row[f"images_per_s_{route}"] = (MOBILENET_BATCH
                                        / row[f"forward_ms_{route}"] * 1e3)
    _log(f"[31b] MobileNet-v1 {MOBILENET_HW}x{MOBILENET_HW}x3, "
         f"{row['params']:,} params, batch "
         f"{MOBILENET_BATCH}: {len(sites)} routed sites ({launches} "
         f"launches over 2 forwards), logits rel L2 {rel:.3e} (tol "
         f"{MOBILENET_REL_L2}; one TF32 product a term {rel_one_pass:.3e}); "
         f"forward {row['forward_ms_kernel']:.2f} ms kernel route "
         f"({row['images_per_s_kernel']:.1f} images/s), "
         f"{row['forward_ms_stock']:.2f} ms stock "
         f"({row['images_per_s_stock']:.1f}); peak "
         f"{row['peak_mib_kernel']:.0f} / {row['peak_mib_stock']:.0f} MiB "
         f"[{smi}]")
    row["sites"] = [(e.m, e.k, e.n, e.act) for _, _, e in sites]
    return row


# --------------------------------------------------------------------------
# (c) C3D trained
# --------------------------------------------------------------------------

def c3d_conf(seed=LAYER_SEED):
    from deeplearning4j_tpu_torch.conf import layers_extra as px
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.inputs import InputType
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.conf.layers_cnn import ConvolutionMode
    from deeplearning4j_tpu_torch.conf.multilayer import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.conf.weights import WeightInit

    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Sgd(learning_rate=C3D_LR)).weight_init(WeightInit.RELU)
         .use_kernels(True).list())

    def conv(n):
        b.layer(px.Convolution3D(n_out=n, kernel_size=(3, 3, 3),
                                 activation=Activation.RELU))

    def pool(k, mode=ConvolutionMode.TRUNCATE):
        b.layer(px.Subsampling3DLayer(kernel_size=k, stride=k,
                                      convolution_mode=mode))

    conv(64)
    pool((1, 2, 2))
    conv(128)
    pool((2, 2, 2))
    for n in (256, 512):
        conv(n)
        conv(n)
        pool((2, 2, 2))
    conv(512)
    conv(512)
    pool((2, 2, 2), ConvolutionMode.SAME)
    b.layer(DenseLayer(n_out=4096, activation=Activation.RELU))
    b.layer(DenseLayer(n_out=4096, activation=Activation.RELU))
    b.layer(OutputLayer(n_out=C3D_CLASSES, activation=Activation.SOFTMAX))
    return b.set_input_type(InputType.convolutional_3d(*C3D_CLIP, 3)).build()


def c3d_batch(seed=LAYER_SEED):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C3D_BATCH, *C3D_CLIP, 3)).astype(np.float32)
    y = np.eye(C3D_CLASSES, dtype=np.float32)[
        rng.integers(0, C3D_CLASSES, C3D_BATCH)]
    return DataSet(x, y)


def _step_ms(torch, net, ds, steps=2) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        net.fit_batch(ds)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / steps * 1e3


def c3d_pair(torch, dev, seed=LAYER_SEED):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = c3d_conf(seed)
    net = MultiLayerNetwork(conf, device=dev).init()
    ref = MultiLayerNetwork(dataclasses.replace(conf, use_kernels=False),
                            device=dev).set_params(net.params, net.state)
    return conf, net, ref


def c3d_errors(torch, net, ref, ds, count=False) -> dict:
    """Step-1 gradients, ``C3D_STEPS`` fit losses and the params after
    them, kernel route against stock; with ``count``, row 1's launches over
    the kernel route's fit alone."""
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.kernels import impls
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener,
    )

    (gk, lk), (gr, lr) = (m.compute_gradient_and_score(ds)
                          for m in (net, ref))
    grad = cs._grad_errors(gk, gr)
    del gk, gr
    p0 = {k: {p: v.detach().clone() for p, v in vp.items()}
          for k, vp in net.params.items()}
    scores, step1 = [], []
    for m in (net, ref):
        collect = CollectScoresListener()
        m.set_listeners(collect)
        if m is net and count:
            # ---- the main path: counts from here on belong to it ----
            cs.reset_launch_counts()
        m.fit(ListDataSetIterator([ds]))
        step1.append(_moves(m.params, p0))
        m.fit(ListDataSetIterator([ds] * (C3D_STEPS - 1)))
        torch.cuda.synchronize()
        if m is net and count:
            launches = cs.launch_counts()["matmul_bias_act"]
            by_shape = dict(impls.matmul_bias_act.shapes)
            # ---- end of the main path ----
        m.set_listeners()
        scores.append(collect.scores)
    moved = {f"{k}.{p}": float((net.params[k][p] - p0[k][p]).abs().max())
             for k in net.params for p in net.params[k]}
    out = {"grad": cs._summary(grad), "score_kernel": lk, "score_stock": lr,
           "losses_kernel": scores[0], "losses_stock": scores[1],
           "loss_rel_err": [abs(a - b) / abs(b)
                            for a, b in zip(*scores)],
           "params": param_errors(torch, *step1),
           "params_after_steps": param_errors(
               torch, _moves(net.params, p0), _moves(ref.params, p0)),
           "moved": moved, "_grad": grad}
    if count:
        out.update(launches=launches, by_shape=by_shape)
    # the control: step 1 of the kernel route from the same params with
    # row 1's operands rounded to TF32 (one TF32 product a term)
    import chip_zoo

    net.set_params(p0, net.state)
    with chip_zoo.one_pass_row1(torch):
        net.fit(ListDataSetIterator([ds]))
    out["params_one_pass"] = param_errors(torch, _moves(net.params, p0),
                                          step1[1])
    return out


def _moves(params, p0) -> dict:
    """How far each param moved from ``p0``: SGD's updates, whose
    difference between the routes is the gradients' times the rate."""
    return {k: {p: v - p0[k][p] for p, v in vp.items()}
            for k, vp in params.items()}


def param_errors(torch, pa, pb) -> dict:
    """Params ``pa`` against ``pb``: the relative L2 of all tensors
    together (``global``) and the worst tensor's own (``worst``), which
    for a tensor that starts at zero and moved a few steps is relative to
    little and reported only."""
    num = den = 0.0
    worst = ("", 0.0)
    for k in pb:
        for p in pb[k]:
            a, b = pa[k][p].double(), pb[k][p].double()
            d2, b2 = float(((a - b) ** 2).sum()), float((b * b).sum())
            num, den = num + d2, den + b2
            rel = (d2 / max(b2, 1e-300)) ** 0.5
            if rel > worst[1]:
                worst = (f"{k}.{p}", rel)
    return {"global": (num / max(den, 1e-300)) ** 0.5, "worst": worst}


def train_c3d(torch, dev, smi) -> dict:
    """(c) C3D trained on both routes."""
    from deeplearning4j_tpu_torch.kernels import routing

    t0 = time.monotonic()
    conf, net, ref = c3d_pair(torch, dev)
    ds = c3d_batch()
    flat = conf.layers[C3D_FLATTEN]
    if type(flat).__name__ != "Cnn3DToFeedForwardPreProcessor" or \
            flat.depth * flat.height * flat.width * flat.channels \
            != C3D_FC6_IN:
        raise AssertionError(f"[31c] fc6 reads {flat}, not {C3D_FC6_IN} "
                             f"inputs")
    sites = routing.routed_sites(conf, C3D_BATCH, mode="cuda")
    build_s = time.monotonic() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = c3d_errors(torch, net, ref, ds, count=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    want = {}
    for _, _, e in sites:
        key = (e.m, e.k, e.n, e.act)
        want[key] = want.get(key, 0) + C3D_STEPS
    if err["launches"] != C3D_STEPS * len(sites) or err["by_shape"] != want \
            or len(sites) != 2:
        raise AssertionError(f"[31c] matmul_bias_act launched "
                             f"{err['launches']} times over {C3D_STEPS} "
                             f"steps, by shape {err['by_shape']}; expected "
                             f"{want}")
    finite = all(math.isfinite(v) for v in err["losses_kernel"])
    cs._check_fixed("31c", err.pop("_grad"), cs.TRAIN_GRAD_L2,
                    cs.TRAIN_GRAD_MAXREL, err["loss_rel_err"],
                    (err["losses_kernel"], err["losses_stock"]), finite, 0.0)
    par, ctl = err["params"]["global"], err["params_one_pass"]["global"]
    if not par <= C3D_PARAM_REL_L2 < ctl:
        raise AssertionError(f"[31c] params after step 1 differ "
                             f"by {par:.3e} relative, {ctl:.3e} with one "
                             f"TF32 product a term (tol {C3D_PARAM_REL_L2}: "
                             f"the first within, the second outside)")
    still = [k for k, v in err["moved"].items()
             if int(k.split(".")[0]) < C3D_FLATTEN and v == 0.0]
    if still:
        raise AssertionError(f"[31c] 3-D conv params that did not move: "
                             f"{still}")
    row = {"params": net.num_params(), "build_s": build_s,
           "launches": err["launches"], "routed_sites": len(sites),
           "by_shape": {str(k): v for k, v in err["by_shape"].items()},
           "grad": err["grad"], "losses_kernel": err["losses_kernel"],
           "losses_stock": err["losses_stock"],
           "loss_rel_err": err["loss_rel_err"],
           "param_moves": err["params"],
           "param_moves_one_pass": err["params_one_pass"],
           "param_moves_after_steps": err["params_after_steps"],
           "peak_mib_compare": peak,
           "step_ms_kernel": _step_ms(torch, net, ds),
           "step_ms_stock": _step_ms(torch, ref, ds)}
    row["clips_per_s_kernel"] = C3D_BATCH / row["step_ms_kernel"] * 1e3
    row["clips_per_s_stock"] = C3D_BATCH / row["step_ms_stock"] * 1e3
    _log(f"[31c] C3D {'x'.join(map(str, C3D_CLIP))}x3, {row['params']:,} "
         f"params, batch "
         f"{C3D_BATCH}, SGD({C3D_LR}): step-1 gradients global L2 "
         f"{err['grad']['global_l2']:.3e} (tol {cs.TRAIN_GRAD_L2}), losses "
         f"kernel {err['losses_kernel']} stock {err['losses_stock']}, the "
         f"params' moves in step 1 {par:.3e} (tol "
         f"{C3D_PARAM_REL_L2}; one "
         f"TF32 product a term {ctl:.3e}; worst tensor "
         f"{err['params']['worst']}); matmul_bias_act {err['launches']} "
         f"launches "
         f"over the fit ({len(sites)} sites a step); step "
         f"{row['step_ms_kernel']:.1f} ms kernel route, "
         f"{row['step_ms_stock']:.1f} ms stock; peak {peak:.0f} MiB (both "
         f"nets and the comparison) [{smi}]")
    row["sites"] = [(e.m, e.k, e.n, e.act) for _, _, e in sites]
    return row


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def layer_shapes(mobile, c3d) -> list:
    """(label, M, K, N, activation, sites, launches) of (d)'s shapes:
    launches those counted at the shape in (b) and (c)."""
    def launches(row, key):
        return int(row["by_shape"].get(str(key), 0))

    fc6, fc7 = c3d["sites"]
    first, last = mobile["sites"][0], mobile["sites"][-1]
    return [("C3D fc6",) + tuple(fc6) + (1, launches(c3d, fc6)),
            ("C3D fc7",) + tuple(fc7) + (1, launches(c3d, fc7)),
            ("MobileNet pw1",) + tuple(first) + (1, launches(mobile, first)),
            ("MobileNet pw13",) + tuple(last) + (1, launches(mobile, last))]


def layers_dsl_phase(torch, F, dev, smi) -> tuple:
    """[31]: returns the ``{"layers": ...}`` line and row 1's ``layers``
    entry for the kernels line."""
    import chip_zoo

    t_start = time.monotonic()
    layer_rows = layers_phase(torch, dev, smi)
    mobile = serve_mobilenet(torch, dev, smi)
    torch.cuda.empty_cache()
    c3d = train_c3d(torch, dev, smi)
    torch.cuda.empty_cache()
    shape_rows = chip_zoo.time_zoo_shapes(torch, F, dev,
                                          layer_shapes(mobile, c3d), "31d")
    wall = time.monotonic() - t_start
    _log(f"[31] the layer DSL in {wall:.1f} s [{smi}]")
    row1 = {
        "launches": mobile["launches"] + c3d["launches"],
        "scope": ("[31]: MobileNet-v1's 13 pointwise convs over two gated "
                  "forwards at batch 8, and C3D's fc6 / fc7 over 3 fit "
                  "steps at batch 8, as counted; shapes: launches as "
                  "counted there, times of one float32 launch at a time; "
                  "library = F.linear then the activation"),
        "shapes": shape_rows,
    }
    line = {"card": smi, "seconds": wall, "layers": layer_rows,
            "mobilenet_v1": {k: v for k, v in mobile.items()
                             if k != "sites"},
            "c3d": {k: v for k, v in c3d.items() if k != "sites"}}
    return line, row1


def spread(torch, dev, n, smi) -> dict:
    """(a)'s, (b)'s and (c)'s errors at ``n`` seeds from ``LAYER_SEED``
    on, no gate applied: the readings the limits are set from."""
    import chip_zoo

    out = {"layers": {}, "mobilenet": {"kernel": [], "one_pass": []},
           "c3d": {"grad": [], "loss": [], "params": [], "one_pass": [],
                   "losses": []}}
    for seed in range(LAYER_SEED, LAYER_SEED + n):
        for case in layer_cases():
            row = check_layer(torch, dev, case, seed)
            out["layers"].setdefault(case[0], []).append(row["errors"])
        pair = mobilenet_pair(torch, dev, seed)
        z_ref = chip_zoo.logits(torch, pair["ref"], pair["x"])
        out["mobilenet"]["kernel"].append(chip_zoo._rel_l2(
            torch, chip_zoo.logits(torch, pair["net"], pair["x"]), z_ref))
        out["mobilenet"]["one_pass"].append(
            chip_zoo.one_pass_rel(torch, pair, z_ref))
        del pair
        torch.cuda.empty_cache()
        _, net, ref = c3d_pair(torch, dev, seed)
        err = c3d_errors(torch, net, ref, c3d_batch(seed))
        out["c3d"]["grad"].append(err["grad"]["global_l2"])
        out["c3d"]["loss"].append(max(err["loss_rel_err"]))
        out["c3d"]["params"].append(err["params"]["global"])
        out["c3d"].setdefault("after_steps", []).append(
            err["params_after_steps"]["global"])
        out["c3d"]["one_pass"].append(err["params_one_pass"]["global"])
        out["c3d"]["losses"].append(err["losses_kernel"])
        del net, ref
        torch.cuda.empty_cache()
        _log(f"[31 spread] seed {seed}: MobileNet logits "
             f"{out['mobilenet']['kernel'][-1]:.3e} (one pass "
             f"{out['mobilenet']['one_pass'][-1]:.3e}); C3D grad "
             f"{out['c3d']['grad'][-1]:.3e}, losses "
             f"{out['c3d']['loss'][-1]:.3e}, params "
             f"{out['c3d']['params'][-1]:.3e} (one pass "
             f"{out['c3d']['one_pass'][-1]:.3e}), losses "
             f"{out['c3d']['losses'][-1]} [{smi}]")
    worst = {label: {k: max(e[k] for e in errs) for k in errs[0]}
             for label, errs in out["layers"].items()}
    _log(f"[31 spread] card vs CPU, worst of {n} seeds: "
         f"{json.dumps(worst)}")
    return out


def main() -> int:
    """The build and [31] alone, or ``--spread N``."""
    import argparse
    import sys

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="read the errors at N seeds instead")
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
        _log(json.dumps({"layers_spread": spread(torch, dev, args.spread,
                                                 smi), "card": smi}))
        return 0
    line, row1 = layers_dsl_phase(torch, F, dev, smi)
    _log(json.dumps({"layers": line, "row1": row1}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
