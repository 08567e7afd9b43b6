#!/usr/bin/env python3
"""Where the generation path's time goes on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_gen_profile.py [--windows 5]

Builds ``chip_smoke.py``'s causal LM (GPT-2 small's widths, seeded
weights, float32), prefills 8 of its seeded prompts into a full running
batch (KV bucket 1024, prompt bucket 1024), then traces with
``torch.profiler`` (CPU and CUDA activities), on the ``use_kernels`` route
and on the stock route: one prefill of those 8 prompts, and ``--windows``
decode windows of ``fused_steps`` steps with all 8 rows live. Prints one
JSON line per (route, phase): the wall time per prefill or per decode step,
the device time (the sum of all kernel durations), the device's idle share
(1 - device time / wall time, kernels counted as if they never overlap),
the kernel launches per step, and the kernels with the most device time,
by name. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def trace(torch, fn, reps: int) -> dict:
    """Profile ``reps`` calls of ``fn`` (warmed once first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.device_time > 0:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time
            launches += 1
    device_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "launches": launches,
            "top": [[name[:90], us / 1e3] for name, us in top]}


def per(row: dict, n: int) -> dict:
    out = {k: (v / n if k in ("wall_ms", "device_ms", "launches") else v)
           for k, v in row.items()}
    out["top"] = [[name, ms / n] for name, ms in row["top"]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_gen_profile: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    dev = torch.device("cuda", 0)
    zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                             seed=cs.GEN_SEED, **cs.GEN_MODEL)
    net = zoo.init(device=dev)
    kw = {k: cs.GEN_CONFIG[k] for k in ("max_batch", "kv_bucket_min",
                                        "prompt_bucket_min")}
    k, bp, s = cs.GEN_CONFIG["fused_steps"], cs.GEN_CONFIG["max_batch"], \
        zoo.max_len
    prompts = cs.gen_requests(bp, zoo.vocab_size, cs.GEN_SEED)
    batch = np.full((bp, s), 0, np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in prompts])
    ones = np.ones((bp,), np.int64)
    card = cs.nvidia_smi_line()
    for route in ("kernel", "stock"):
        dec = TransformerDecoder(net, max_len=zoo.max_len, **kw)
        dec.use_kernels = route == "kernel"
        params = dec.params

        def prefill():
            return dec.prompt_fn(s, bp)(params, batch, lengths, ones * s,
                                        -ones, np.zeros((bp,)), [None] * bp)

        row = trace(torch, prefill, 1)
        print(json.dumps({"route": route, "phase": "prefill", "rows": bp,
                          "prompt_bucket": s, "card": card, **row}),
              flush=True)
        kv, tok, active, rng = prefill()
        state = dec.join_fn(s, s, bp)(
            dec.new_state(s), kv, np.arange(bp), tok, lengths, ones * s,
            -ones, np.zeros((bp,)), rng, active)
        window = dec.decode_fn(s, k)
        row = trace(torch, lambda: window(params, state), args.windows)
        print(json.dumps({"route": route, "phase": "decode_step",
                          "rows": bp, "kv_bucket": s, "card": card,
                          **per(row, args.windows * k)}), flush=True)
        del state, kv
    return 0


if __name__ == "__main__":
    sys.exit(main())
