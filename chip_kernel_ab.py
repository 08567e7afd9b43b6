#!/usr/bin/env python3
"""Compare the checkout's version of a CUDA kernel with another version of
its source, on one CUDA card.

Run from the root of a checkout::

    python3 chip_kernel_ab.py OLD.cu [--kernel matmul_bias_act] [--pairs 10]

``OLD.cu`` is another version of ``deeplearning4j_tpu_torch/csrc/
<kernel>.cu`` (same C interface), e.g. the parent commit's, written out
with ``git show <rev>:deeplearning4j_tpu_torch/csrc/<kernel>.cu``. Both
are built with the same nvcc flags and, in one process on one card:

1. compared element for element at the main path's shapes, float32 and
   bfloat16 (``bitwise`` says whether every output is identical);
2. timed per shape (float32, CUDA-event medians) in ``--pairs``
   alternating pairs, old-new then new-old;
3. timed end to end with the route sending the kernel's calls to each
   version in turn, ``--pairs`` alternating pairs.

``--kernel matmul_bias_act`` (the default): ResNet-50's 15 distinct 1x1-conv
shapes at batch 32 plus ragged shapes, identity / relu / gelu; end to end,
ResNet-50 ``output`` at batch 32. ``--kernel paged_decode_attention``: the
chip_smoke decode checks (B 8, H 12, D 64, each S of the KV ladder); per S,
seeded positions in [S/2, S); end to end, the GPT-2-small-width LM's
``GenerationEngine`` over chip_smoke's 16 requests (tokens/s).

Prints one JSON line per shape and a final summary line with quartiles and
the count of pairs the new version won. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def quartiles(v):
    return [float(q) for q in np.percentile(v, [25, 50, 75])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the other version's .cu source")
    ap.add_argument("--kernel", default="matmul_bias_act",
                    choices=("matmul_bias_act", "paged_decode_attention"))
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    if args.kernel == "paged_decode_attention":
        return ab_decode(torch, args)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    print(cs.nvidia_smi_line(), flush=True)
    build.build_all([impls.SOURCE])
    old_so = build.BUILD_DIR / "libmatmul_bias_act-old.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(old_so), str(args.old)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(old_so))
    for fn, (restype, argtypes) in impls._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    dtype_ids = {torch.float32: 0, torch.bfloat16: 1}

    def old(x, w, b, act):
        y = torch.empty((x.shape[0], w.shape[0]), dtype=x.dtype,
                        device=x.device)
        rc = lib.dl4j_matmul_bias_act(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.shape[0], w.shape[0], x.shape[1], dtype_ids[x.dtype],
            impls.ACTIVATION_IDS[act.value], x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old kernel launch failed: CUDA error {rc}")
        return y

    new = impls.matmul_bias_act
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = cs.path_shapes(ResNet50().conf(), cs.BATCH)

    # 1. element for element
    bitwise = True
    for (m, k, n) in sorted(set(shapes)) + list(cs.RAGGED):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
        b = torch.randn((n,), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            for name in ("identity", "relu", "gelu"):
                a = Activation(name)
                args_ = (x.to(dt), w.to(dt), b.to(dt), a)
                if not torch.equal(old(*args_), new(*args_)):
                    bitwise = False
    print(json.dumps({"bitwise": bitwise}), flush=True)

    # 2. per shape
    act = Activation("identity")
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    rows = []
    for (m, k, n), count in counts.items():
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
        b = torch.zeros((n,), device=dev)
        times = {"old": [], "new": []}
        for i in range(args.pairs):
            for side in (("old", "new") if i % 2 == 0 else ("new", "old")):
                fn = old if side == "old" else new
                times[side].append(
                    cs.cuda_time_ms(lambda: fn(x, w, b, act), samples=5))
        row = {"m": m, "k": k, "n": n, "count": count,
               "old_ms": quartiles(times["old"]),
               "new_ms": quartiles(times["new"]),
               "new_wins": sum(t_new < t_old for t_old, t_new
                               in zip(times["old"], times["new"]))}
        rows.append(row)
        print(json.dumps(row), flush=True)

    # 3. end to end
    conf = dataclasses.replace(ResNet50().conf(), use_kernels=True)
    net = ComputationGraph(conf, device=dev).init()
    cs.randomize_bn(net, 0)
    xb = np.random.default_rng(7).random((cs.BATCH, 224, 224, 3), np.float32)

    def forward_ms(reps=10):
        net.output(xb)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            net.output(xb)
        return (time.monotonic() - t0) / reps * 1e3

    fwd = {"old": [], "new": []}
    try:
        for i in range(args.pairs):
            for side in (("old", "new") if i % 2 == 0 else ("new", "old")):
                impls.matmul_bias_act = old if side == "old" else new
                fwd[side].append(forward_ms())
    finally:
        impls.matmul_bias_act = new
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "bitwise": bitwise,
        "per_forward_old_ms": sum(r["old_ms"][1] * r["count"] for r in rows),
        "per_forward_new_ms": sum(r["new_ms"][1] * r["count"] for r in rows),
        "forward_old_ms": quartiles(fwd["old"]),
        "forward_new_ms": quartiles(fwd["new"]),
        "forward_new_wins": sum(t_new < t_old for t_old, t_new
                                in zip(fwd["old"], fwd["new"])),
        "pairs": args.pairs}), flush=True)
    return 0


def _build_old(build, name, source, signatures):
    """The other version's library, built with the checkout's flags."""
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    build.build_all([name])
    old_so = build.BUILD_DIR / f"lib{name}-old.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(old_so), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    lib = ctypes.CDLL(str(old_so))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def ab_decode(torch, args) -> int:
    """The A/B of ``paged_decode_attention``: the wrapper launches the
    library that ``build.load`` hands it, so each version is swapped in
    through the loaded-library table."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.nn.graph import serve_full_f32
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    name = impls.DECODE_SOURCE
    serve_full_f32()
    old_lib = _build_old(build, name, args.old, att._DECODE_SIGNATURES)
    new_lib = build.load(name, att._DECODE_SIGNATURES)

    def use(side):
        build._LIBS[name] = old_lib if side == "old" else new_lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    h, d = cs.GEN_MODEL["n_heads"], cs.GEN_HEAD_DIM
    bitwise, rows = True, []
    try:
        for s in cs.GEN_KV_LADDER:
            pos = cs.decode_positions(torch, gen, dev, s)
            for dt in (torch.float32, torch.bfloat16):
                q = torch.randn((8, h, d), generator=gen, device=dev).to(dt)
                kc, vc = (torch.randn((8, s, h, d), generator=gen,
                                      device=dev).to(dt) for _ in range(2))
                outs = {}
                for side in ("old", "new"):
                    use(side)
                    outs[side] = att.paged_decode_attention(q, kc, vc, pos)
                bitwise &= bool(torch.equal(outs["old"], outs["new"]))
            pos = torch.randint(s // 2, s, (8,), generator=gen,
                                device=dev).to(torch.int32)
            q = torch.randn((8, h, d), generator=gen, device=dev)
            kc, vc = (torch.randn((8, s, h, d), generator=gen, device=dev)
                      for _ in range(2))
            times = {"old": [], "new": []}
            for i in range(args.pairs):
                for side in (("old", "new") if i % 2 == 0
                             else ("new", "old")):
                    use(side)
                    times[side].append(cs.cuda_time_ms(
                        lambda: att.paged_decode_attention(q, kc, vc, pos),
                        samples=5))
            row = {"s": s, "positions": pos.tolist(),
                   "old_ms": quartiles(times["old"]),
                   "new_ms": quartiles(times["new"]),
                   "new_wins": sum(t_new < t_old for t_old, t_new
                                   in zip(times["old"], times["new"]))}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({"bitwise": bitwise}), flush=True)

        zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                 seed=cs.GEN_SEED, **cs.GEN_MODEL)
        dec = TransformerDecoder(
            zoo.init(device=dev), max_len=zoo.max_len,
            **{k: cs.GEN_CONFIG[k] for k in ("max_batch", "kv_bucket_min",
                                             "prompt_bucket_min")})
        dec.warmup(fused_steps=(cs.GEN_CONFIG["fused_steps"],))
        prompts = cs.gen_requests(cs.GEN_REQUESTS, zoo.vocab_size,
                                  cs.GEN_SEED)
        tps = {"old": [], "new": []}
        for i in range(args.pairs):
            for side in (("old", "new") if i % 2 == 0 else ("new", "old")):
                use(side)
                _, timing, _ = cs._engine_run(torch, dec, prompts,
                                              cs.GEN_MAX_NEW)
                tps[side].append(timing["tokens_per_s"])
    finally:
        use("new")
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "kernel": name, "bitwise": bitwise,
        "engine_tokens_per_s_old": quartiles(tps["old"]),
        "engine_tokens_per_s_new": quartiles(tps["new"]),
        "engine_new_wins": sum(t_new > t_old for t_old, t_new
                               in zip(tps["old"], tps["new"])),
        "pairs": args.pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
