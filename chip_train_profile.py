#!/usr/bin/env python3
"""Where a training step's time goes on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_train_profile.py [--model resnet50|transformer]
                                  [--batch N] [--steps 3]

``resnet50`` (the default): full-width ResNet-50 with ``fused_conv_bn=True``
(224x224x3, 1000 classes, seeded weights, the default Adam(1e-3)), batch 32.
``transformer``: the GPT-2-small-width causal LM of ``chip_smoke.py`` (vocab
50257, 768 wide, 12 heads, 12 layers, seeded weights, Adam(1e-3)) on a
micro-batch of 8 x 1024 seeded tokens with one-hot next-token labels built
on the card. Each model is built on the ``use_kernels=True`` route and on
the stock route, warmed up, then ``--steps`` ``fit_batch`` steps of each
are traced with ``torch.profiler`` (CPU and CUDA activities). Prints, per
route, one JSON line: the wall time per step, the device time per step (the
sum of all kernel durations), the device's idle share (1 - device time /
wall time, kernels counted as if they never overlap), the kernel launches
per step, and the kernels with the most device time per step, by name.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def profile_route(torch, net, ds, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        net.fit_batch(ds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            net.fit_batch(ds)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / steps * 1e3
    kernels, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.device_time > 0:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time
            launches += 1
    device_ms = sum(kernels.values()) / steps / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "launches_per_step": launches / steps,
            "top": [[name[:90], us / steps / 1e3] for name, us in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("resnet50", "transformer"),
                    default="resnet50")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 32 (resnet50), 8 sequences (transformer)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_train_profile: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import (
        ResNet50,
        TransformerEncoder,
    )

    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    if args.model == "transformer":
        batch = args.batch or cs.LM_BATCH
        zoo = TransformerEncoder(causal=True, lm_head=True, seed=cs.GEN_SEED,
                                 **cs.GEN_MODEL)
        net, ref = cs._route_pair(torch, dev, zoo)
        ds = cs.lm_dataset(torch, dev, zoo.vocab_size, batch, zoo.max_len,
                           cs.LM_SEED)
    else:
        batch = args.batch or cs.BATCH
        zoo = ResNet50()
        zoo.fused_conv_bn = True
        conf = dataclasses.replace(zoo.conf(), use_kernels=True)
        net = ComputationGraph(conf, device=dev).init()
        cs.condition_residual_bn(net)
        ref = ComputationGraph(dataclasses.replace(conf, use_kernels=False),
                               device=dev).set_params(net.params, net.state)
        ds = cs._synthetic_batch(zoo, batch, 0)
    for route, model in (("kernel", net), ("stock", ref)):
        out = profile_route(torch, model, ds, args.steps)
        print(json.dumps({"model": args.model, "route": route,
                          "batch": batch, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
