#!/usr/bin/env python3
"""Compare the checkout's version of a CUDA kernel with another version of
its source, on one CUDA card.

Run from the root of a checkout::

    python3 chip_kernel_ab.py OLD.cu [--kernel matmul_bias_act] [--pairs 10]
    python3 chip_kernel_ab.py --variant NAME=VALUE [--kernel ...] [--pairs N]

``OLD.cu`` is another version of ``deeplearning4j_tpu_torch/csrc/
<kernel>.cu`` (same C interface), e.g. the parent commit's, written out
with ``git show <rev>:deeplearning4j_tpu_torch/csrc/<kernel>.cu``. Both
are built with the same nvcc flags and, in one process on one card:

1. compared element for element at the main path's shapes, float32 and
   bfloat16 (``bitwise`` says whether every output is identical; for
   ``matmul_bias_act``, ``within_tolerance`` whether both versions stay
   within ``KERNEL_TOL`` of the plain version, which gates the exit code:
   versions that sum in other orders are not bitwise equal);
2. timed per shape (float32, CUDA-event medians) in ``--pairs``
   alternating pairs, old-new then new-old;
3. timed end to end with the route sending the kernel's calls to each
   version in turn, ``--pairs`` alternating pairs.

``--kernel matmul_bias_act`` (the default): ResNet-50's 15 distinct 1x1-conv
shapes at batch 32 plus ragged shapes, identity / relu / gelu; end to end,
ResNet-50 ``output`` at batch 32. ``--kernel paged_decode_attention``: the
chip_smoke decode checks (B 8, H 12, every head size of
``DECODE_HEAD_DIMS``, each S of the KV ladder), both versions within
``DECODE_TOL`` of ``paged_decode_attention_plain`` (the exit code's gate;
``bitwise`` is reported beside it); per S at D 64, seeded positions in
[S/2, S), CUDA-event and device times (``torch.profiler``: the event time of
a launch this short is mostly the wrapper's host work); end to end, the
GPT-2-small-width LM's ``GenerationEngine`` over chip_smoke's 16 requests
(tokens/s).
``--kernel flash_attention`` (the forward): both versions against
``flash_attention_plain`` at every case of ``chip_smoke.flash_cases()`` in
float32 and bfloat16 (within ``ATTN_TOL``, not bitwise); timed at every
generation prefill bucket (join 1..8 x prompt 8..1024, causal with a
prompt-length mask, float32) and at [8, 12, 1024, 64] causal unmasked (the
LM's training shape) beside SDPA in the same pairs; end to end, an 8 x 1024
prefill of the GPT-2-small-width LM (``prompt_fn``) and its ``fit_batch``
at 8 x 1024 tokens. The forward's tiles live in ``csrc/flash_common.cuh``:
OLD.cu is built against the ``flash_common.cuh`` beside it (write out the
other version's header next to OLD.cu), the shared ``.cuh`` it does not
find there from ``csrc/``.
``--kernel matmul_stats``: both versions against ``matmul_stats_plain`` at
ResNet-50's 15 distinct 1x1 shapes plus ragged ones, float32 and bfloat16 (y
within ``KERNEL_TOL``, the column statistics within ``STATS_RTOL``; not
bitwise: the FFMA and tensor-core versions sum in other orders); timed per
shape (CUDA events, and device time by ``torch.profiler``); end to end, the
``fused_conv_bn`` ResNet-50's ``fit_batch`` at batch 32. A version written
against another ``ffma_gemm.cuh`` (the FFMA one of commit 6d54560) needs
that header written out beside OLD.cu (the build looks there first).
``--kernel flash_attention_bwd`` (the dq and dk/dv kernels, one source):
both versions against ``flash_attention_bwd_plain`` at every case of
``chip_smoke.flash_bwd_cases()`` in float32 and bfloat16 (within
``ATTN_BWD_TOL``, not bitwise: the versions sum in other orders); dq and
dk/dv timed apart at the LM's shape ([8, 12, 1024, 64], causal, float32)
beside autograd through causal SDPA in the same pairs; end to end, the
GPT-2-small-width LM's ``fit_batch`` at 8 x 1024 tokens (ms a step).
``--kernel matmul_bias_act_int8``: both versions against
``matmul_bias_act_int8_plain`` at chip_smoke's [16] shapes (AlexNet's two
sites at every serving bucket, ResNet-50's 15 1x1 shapes, the ragged
ones): the int32 sums (identity, scale 1, bias 0) bit for bit, identity and
relu within ``INT8_MAX_ULP`` (the exit code's gate); per shape, CUDA-event
and device times, the AlexNet sites with the weights rotated through
>150 MB of copies as [18] does; end to end, the quantized AlexNet's forward
at batch 32 on the card and its images/s through ``InferenceEngine``. OLD.cu
may also have PR 8's interface (``dl4j_matmul_int8_splits`` and a split-K
workspace the caller allocates): that side then runs PR 8's wrapper, so the
event times carry each version's own host work.

``--variant NAME=VALUE`` (repeatable) takes the place of OLD.cu: the "old"
side is then the checkout's source with the one ``constexpr int`` (or
``bool``) ``NAME`` set to VALUE, e.g. ``--kernel paged_decode_attention
--variant kStageElems=4096`` for larger decode stages.

Prints one JSON line per shape and a final summary line with quartiles and
the count of pairs the new version won. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def quartiles(v):
    return [float(q) for q in np.percentile(v, [25, 50, 75])]


# the --kernel modes, each named after its source csrc/<kernel>.cu
KERNELS = ("matmul_bias_act", "matmul_stats", "paged_decode_attention",
           "flash_attention", "flash_attention_bwd", "matmul_bias_act_int8")


def variant_source(csrc: Path, name: str, settings, out_dir: Path) -> Path:
    """The checkout's ``csrc/<name>.cu`` with each ``NAME=VALUE`` of
    ``settings`` set (the one ``constexpr int|bool NAME = ...;`` line of
    the source), written to ``out_dir`` beside copies of the shared
    headers. Raises if a name does not occur exactly once."""
    src = (csrc / f"{name}.cu").read_text()
    for setting in settings:
        key, _, value = setting.partition("=")
        pattern = rf"(constexpr (?:int|bool) {re.escape(key)} = )[^;]+;"
        src, n = re.subn(pattern, rf"\g<1>{value};", src)
        if n != 1 or not value:
            raise ValueError(f"--variant {setting}: {n} definitions of "
                             f"{key} in csrc/{name}.cu")
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, nargs="?",
                    help="the other version's .cu source")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="instead of OLD.cu: the checkout's source with the "
                         "constant NAME set to VALUE (repeatable)")
    ap.add_argument("--kernel", default="matmul_bias_act",
                    choices=KERNELS)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if (args.old is None) == (not args.variant):
        ap.error("give either OLD.cu or --variant")
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    if args.variant:
        from deeplearning4j_tpu_torch.kernels import build

        args.old = variant_source(build.CSRC, args.kernel, args.variant,
                                  build.BUILD_DIR / "variant")
        print(json.dumps({"old": "variant", "settings": args.variant}),
              flush=True)
    if args.kernel == "paged_decode_attention":
        return ab_decode(torch, args)
    if args.kernel == "matmul_stats":
        return ab_stats(torch, args)
    if args.kernel == "flash_attention":
        return ab_flash(torch, args)
    if args.kernel == "flash_attention_bwd":
        return ab_flash_bwd(torch, args)
    if args.kernel == "matmul_bias_act_int8":
        return ab_int8(torch, args)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    lib = _build_old(build, impls.SOURCE, args.old, impls._SIGNATURES)
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

    # 1. element for element, and both versions against the plain version
    bitwise, ok = True, True
    worst = {"old": {}, "new": {}}
    for (m, k, n) in sorted(set(shapes)) + list(cs.RAGGED):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
        b = torch.randn((n,), generator=gen, device=dev)
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            for name in ("identity", "relu", "gelu"):
                a = Activation(name)
                args_ = (x.to(dt), w.to(dt), b.to(dt), a)
                ref = impls.matmul_bias_act_plain(*args_)
                outs = {"old": old(*args_), "new": new(*args_)}
                bitwise &= bool(torch.equal(outs["old"], outs["new"]))
                for side, y in outs.items():
                    err, bad = cs._within(torch, y, ref, cs.KERNEL_TOL[dname])
                    ok &= bad == 0 and bool(torch.isfinite(y.float()).all())
                    worst[side][dname] = max(worst[side].get(dname, 0.0), err)
    print(json.dumps({"bitwise": bitwise, "within_tolerance": ok,
                      "worst": worst, "tol": cs.KERNEL_TOL}), flush=True)

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
        "within_tolerance": ok,
        "per_forward_old_ms": sum(r["old_ms"][1] * r["count"] for r in rows),
        "per_forward_new_ms": sum(r["new_ms"][1] * r["count"] for r in rows),
        "forward_old_ms": quartiles(fwd["old"]),
        "forward_new_ms": quartiles(fwd["new"]),
        "forward_new_wins": sum(t_new < t_old for t_old, t_new
                                in zip(fwd["old"], fwd["new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


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


def ab_stats(torch, args) -> int:
    """The A/B of ``matmul_stats``: the wrapper launches the library that
    ``build.load`` hands it (both its row-block height and its launch), so
    each version is swapped in through the loaded-library table."""
    import math

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50

    name = impls.STATS_SOURCE
    if not (args.old.parent / "ffma_gemm.cuh").is_file():
        print("chip_kernel_ab: put the other version's ffma_gemm.cuh "
              "beside OLD.cu", file=sys.stderr)
        return 1
    old_lib = _build_old(build, name, args.old, impls._STATS_SIGNATURES)
    new_lib = build.load(name, impls._STATS_SIGNATURES)

    def use(side):
        build._LIBS[name] = old_lib if side == "old" else new_lib

    def order(i):
        return ("old", "new") if i % 2 == 0 else ("new", "old")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = cs.path_shapes(ResNet50().conf(), cs.BATCH)
    ok, worst, rows = True, {"old": {}, "new": {}}, []
    try:
        # 1. both versions against the plain version
        for (m, k, n) in sorted(set(shapes)) + list(cs.RAGGED):
            x32 = torch.randn((m, k), generator=gen, device=dev)
            w32 = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
            for dt, dname in ((torch.float32, "float32"),
                              (torch.bfloat16, "bfloat16")):
                x, w = x32.to(dt), w32.to(dt)
                ref = impls.matmul_stats_plain(x, w)
                shape = {"m": m, "k": k, "n": n, "dtype": dname}
                for side in ("old", "new"):
                    use(side)
                    errs, good = cs.stats_errors(torch, impls.matmul_stats(
                        x, w), ref, dname)
                    ok &= good
                    shape[side] = {"within": good, **errs}
                    for key, v in errs.items():
                        key = f"{dname}.{key}"
                        worst[side][key] = max(worst[side].get(key, 0), v)
                print(json.dumps(shape), flush=True)
        print(json.dumps({"within_tolerance": ok, "worst": worst,
                          "tol": [cs.KERNEL_TOL, cs.STATS_RTOL]}), flush=True)

        # 2. per shape, float32
        counts = {}
        for sh in shapes:
            counts[sh] = counts.get(sh, 0) + 1
        for (m, k, n), count in counts.items():
            x = torch.randn((m, k), generator=gen, device=dev)
            w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
            times = {"old": [], "new": []}
            for i in range(args.pairs):
                for side in order(i):
                    use(side)
                    times[side].append(cs.cuda_time_ms(
                        lambda: impls.matmul_stats(x, w), samples=5))
            device = {}
            for side in ("old", "new"):
                use(side)
                device[side] = cs.device_ms(lambda: impls.matmul_stats(x, w),
                                            ["stats_kernel"])
            row = {"m": m, "k": k, "n": n, "count": count,
                   "old_ms": quartiles(times["old"]),
                   "new_ms": quartiles(times["new"]),
                   "old_device_ms": device["old"],
                   "new_device_ms": device["new"],
                   "new_wins": sum(t_new < t_old for t_old, t_new
                                   in zip(times["old"], times["new"]))}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, w

        # 3. end to end: the fused ResNet-50's training step
        zoo = ResNet50()
        zoo.fused_conv_bn = True
        net = ComputationGraph(dataclasses.replace(zoo.conf(),
                                                   use_kernels=True),
                               device=dev).init()
        cs.condition_residual_bn(net)
        ds = cs._synthetic_batch(zoo, cs.BATCH, 0)
        steps = {"old": [], "new": []}
        for side in ("old", "new"):
            use(side)
            net.fit_batch(ds)
        for i in range(args.pairs):
            for side in order(i):
                use(side)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for _ in range(2):
                    net.fit_batch(ds)
                steps[side].append((time.monotonic() - t0) / 2 * 1e3)
    finally:
        use("new")

    def per_step(key):
        return sum(r[key] * r["count"] for r in rows)

    print(json.dumps({
        "card": cs.nvidia_smi_line(), "kernel": name, "within_tolerance": ok,
        "per_step_old_ms": sum(r["old_ms"][1] * r["count"] for r in rows),
        "per_step_new_ms": sum(r["new_ms"][1] * r["count"] for r in rows),
        "per_step_old_device_ms": per_step("old_device_ms"),
        "per_step_new_device_ms": per_step("new_device_ms"),
        "shapes_new_wins": sum(r["new_wins"] for r in rows),
        "shapes_pairs": len(rows) * args.pairs,
        "train_step_old_ms": quartiles(steps["old"]),
        "train_step_new_ms": quartiles(steps["new"]),
        "train_step_new_wins": sum(n < o for o, n in zip(steps["old"],
                                                         steps["new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


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
    h = cs.GEN_MODEL["n_heads"]
    bitwise, ok, rows = True, True, []
    worst = {"old": {}, "new": {}}
    try:
        # 1. both versions against the plain version
        for d in cs.DECODE_HEAD_DIMS:
            for s in cs.GEN_KV_LADDER:
                pos = cs.decode_positions(torch, gen, dev, s)
                for dt, dname in ((torch.float32, "float32"),
                                  (torch.bfloat16, "bfloat16")):
                    q = torch.randn((8, h, d), generator=gen,
                                    device=dev).to(dt)
                    kc, vc = (torch.randn((8, s, h, d), generator=gen,
                                          device=dev).to(dt)
                              for _ in range(2))
                    ref = att.paged_decode_attention_plain(q, kc, vc, pos)
                    outs = {}
                    for side in ("old", "new"):
                        use(side)
                        outs[side] = att.paged_decode_attention(q, kc, vc,
                                                                pos)
                        err, bad = cs._within(torch, outs[side], ref,
                                              cs.DECODE_TOL[dname])
                        ok &= bad == 0 and bool(
                            torch.isfinite(outs[side].float()).all())
                        key = f"{dname}.d{d}"
                        worst[side][key] = max(worst[side].get(key, 0.0), err)
                    bitwise &= bool(torch.equal(outs["old"], outs["new"]))
        print(json.dumps({"within_tolerance": ok, "bitwise": bitwise,
                          "worst": worst, "tol": cs.DECODE_TOL}), flush=True)

        # 2. per S at the path's head size
        d = cs.GEN_HEAD_DIM
        for s in cs.GEN_KV_LADDER:
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
            device = {}
            for side in ("old", "new"):
                use(side)
                device[side] = cs.device_ms(
                    lambda: att.paged_decode_attention(q, kc, vc, pos),
                    ["decode"])
            row = {"s": s, "positions": pos.tolist(),
                   "old_ms": quartiles(times["old"]),
                   "new_ms": quartiles(times["new"]),
                   "old_device_ms": device["old"],
                   "new_device_ms": device["new"],
                   "bound_ms": cs.decode_bound_ms(pos.tolist(), s, h, d,
                                                  4)[1],
                   "new_wins": sum(t_new < t_old for t_old, t_new
                                   in zip(times["old"], times["new"]))}
            rows.append(row)
            print(json.dumps(row), flush=True)

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
        "card": cs.nvidia_smi_line(), "kernel": name,
        "within_tolerance": ok, "bitwise": bitwise,
        "engine_tokens_per_s_old": quartiles(tps["old"]),
        "engine_tokens_per_s_new": quartiles(tps["new"]),
        "engine_new_wins": sum(t_new > t_old for t_old, t_new
                               in zip(tps["old"], tps["new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


def ab_flash(torch, args) -> int:
    """The A/B of the flash forward: the wrapper launches the library that
    ``build.load`` hands it, so each version is swapped in through the
    loaded-library table. The backward (the checkout's) follows whichever
    forward ran."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        serve_full_f32,
    )
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    name = impls.FLASH_SOURCE
    if not (args.old.parent / "flash_common.cuh").is_file():
        print("chip_kernel_ab: put the other version's flash_common.cuh "
              "beside OLD.cu", file=sys.stderr)
        return 1
    serve_full_f32()
    old_lib = _build_old(build, name, args.old, att._FLASH_SIGNATURES)
    new_lib = build.load(name, att._FLASH_SIGNATURES)

    def use(side):
        build._LIBS[name] = old_lib if side == "old" else new_lib

    def order(i):
        return ("old", "new") if i % 2 == 0 else ("new", "old")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    F = torch.nn.functional
    ok, worst = True, {"old": {}, "new": {}}
    try:
        # 1. both versions against the plain version
        for b, tq, tk, d, causal, masked in cs.flash_cases():
            for dtype, tdt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
                q, k, v, km = cs._attention_inputs(torch, gen, dev, b, tq,
                                                   masked, tdt, tk=tk, d=d)
                ref = att.flash_attention_plain(q, k, v, km, causal)
                rows = (km.sum(-1) > 0) if km is not None else \
                    torch.ones(b, dtype=torch.bool, device=dev)
                for side in ("old", "new"):
                    use(side)
                    got = att.flash_attention(q, k, v, km, causal,
                                              return_stats=True)
                    for key, g, r in zip(("o", "l", "m"), got, ref):
                        err, bad = cs._within(torch, g[rows], r[rows],
                                              cs.ATTN_TOL[dtype][key])
                        ok &= bad == 0 and bool(torch.isfinite(g.float()).all())
                        w = worst[side]
                        w[f"{dtype}.{key}"] = max(w.get(f"{dtype}.{key}", 0.0),
                                                  err)
            print(json.dumps({"case": [b, tq, tk, d, causal, masked],
                              "within_tolerance": ok}), flush=True)
        print(json.dumps({"within_tolerance": ok, "worst": worst,
                          "tol": cs.ATTN_TOL}), flush=True)

        # 2. per shape: every generation prefill bucket (masked) and the
        # LM's training shape (unmasked), float32, beside SDPA
        h, d = cs.GEN_MODEL["n_heads"], cs.GEN_HEAD_DIM
        shapes = [(b, t, True) for b in cs.GEN_JOIN_LADDER
                  for t in cs.GEN_PROMPT_LADDER]
        shapes.append((cs.LM_BATCH, cs.GEN_MODEL["max_len"], False))
        rows = []
        for b, t, masked in shapes:
            q, k, v, km = cs._attention_inputs(torch, gen, dev, b, t, masked,
                                               torch.float32)
            keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
            if km is not None:
                keep = keep[None, None] & (km > 0)[:, None, None, :]
            times = {"old": [], "new": [], "sdpa": []}
            for i in range(args.pairs):
                for side in order(i):
                    use(side)
                    times[side].append(cs.cuda_time_ms(
                        lambda: att.flash_attention(q, k, v, km, True),
                        samples=5))
                times["sdpa"].append(cs.cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=keep),
                    samples=5))
            row = {"b": b, "t": t, "masked": masked,
                   **{f"{key}_ms": quartiles(v_) for key, v_ in times.items()},
                   "new_wins": sum(n < o_ for o_, n in zip(times["old"],
                                                           times["new"]))}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, km, keep

        # 3. end to end: an 8 x 1024 prefill and the LM's training step
        zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                 seed=cs.GEN_SEED, **cs.GEN_MODEL)
        net = ComputationGraph(dataclasses.replace(zoo.conf(),
                                                   use_kernels=True),
                               device=dev).init()
        bp, s = cs.GEN_CONFIG["max_batch"], zoo.max_len
        dec = TransformerDecoder(
            net, max_len=s, **{k_: cs.GEN_CONFIG[k_] for k_ in (
                "max_batch", "kv_bucket_min", "prompt_bucket_min")})
        prompts = cs.gen_requests(bp, zoo.vocab_size, cs.GEN_SEED)
        batch = np.zeros((bp, s), np.int64)
        for i, p_ in enumerate(prompts):
            batch[i, :len(p_)] = p_
        lengths = np.asarray([len(p_) for p_ in prompts])
        ones = np.ones((bp,), np.int64)

        def prefill():
            out = dec.prompt_fn(s, bp)(dec.params, batch, lengths, ones * s,
                                       -ones, np.zeros((bp,)), [None] * bp)
            torch.cuda.synchronize()
            return out

        ds = cs.lm_dataset(torch, dev, zoo.vocab_size, cs.LM_BATCH, s,
                           cs.LM_SEED)
        ends = {"prefill_old": [], "prefill_new": [], "step_old": [],
                "step_new": []}
        for side in ("old", "new"):
            use(side)
            prefill()
            net.fit_batch(ds)
        for i in range(args.pairs):
            for side in order(i):
                use(side)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                with torch.inference_mode():
                    prefill()
                ends[f"prefill_{side}"].append((time.monotonic() - t0) * 1e3)
                t0 = time.monotonic()
                for _ in range(2):
                    net.fit_batch(ds)
                ends[f"step_{side}"].append((time.monotonic() - t0) / 2 * 1e3)
    finally:
        use("new")
    by = {r_["b"] * 10000 + r_["t"]: r_ for r_ in rows if r_["masked"]}
    train = [r_ for r_ in rows if not r_["masked"]][0]
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "kernel": name, "within_tolerance": ok,
        "prefill_8x1024_kernel_old_ms": by[8 * 10000 + 1024]["old_ms"],
        "prefill_8x1024_kernel_new_ms": by[8 * 10000 + 1024]["new_ms"],
        "train_8x1024_kernel_old_ms": train["old_ms"],
        "train_8x1024_kernel_new_ms": train["new_ms"],
        "train_8x1024_sdpa_ms": train["sdpa_ms"],
        "shapes_new_wins": sum(r_["new_wins"] for r_ in rows),
        "shapes_pairs": len(rows) * args.pairs,
        **{f"{key}_ms": quartiles(v_) for key, v_ in ends.items()},
        "prefill_new_wins": sum(n < o_ for o_, n in zip(
            ends["prefill_old"], ends["prefill_new"])),
        "step_new_wins": sum(n < o_ for o_, n in zip(ends["step_old"],
                                                     ends["step_new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


def ab_flash_bwd(torch, args) -> int:
    """The A/B of the flash backward kernels: both wrappers launch the
    library that ``build.load`` hands them, so each version is swapped in
    through the loaded-library table."""
    import math

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

    name = impls.FLASH_BWD_SOURCE
    old_lib = _build_old(build, name, args.old, att._FLASH_BWD_SIGNATURES)
    new_lib = build.load(name, att._FLASH_BWD_SIGNATURES)

    def use(side):
        build._LIBS[name] = old_lib if side == "old" else new_lib

    def order(i):
        return ("old", "new") if i % 2 == 0 else ("new", "old")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    ok, worst = True, {"old": {}, "new": {}}
    try:
        # 1. both versions against the plain version
        for b, tq, tk, d, causal, masked in cs.flash_bwd_cases():
            q32, k32, v32, do32, km = cs._bwd_inputs(torch, gen, dev, b, tq,
                                                     tk, d, masked)
            for dtype, tdt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16)):
                q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))
                o, l, m = att.flash_attention(q, k, v, km, causal,
                                              return_stats=True)
                ref = att.flash_attention_bwd_plain(q, k, v, km, o, l, m, do,
                                                    causal)
                for side in ("old", "new"):
                    use(side)
                    got = att.flash_attention_bwd(q, k, v, km, o, l, m, do,
                                                  causal)
                    for key, g, r in zip(("dq", "dk", "dv"), got, ref):
                        err, bad = cs._within(torch, g, r,
                                              cs.ATTN_BWD_TOL[dtype])
                        ok &= bad == 0 and bool(torch.isfinite(g.float()).all())
                        w = worst[side]
                        w[f"{dtype}.{key}"] = max(w.get(f"{dtype}.{key}", 0.0),
                                                  err)
            print(json.dumps({"case": [b, tq, tk, d, causal, masked],
                              "within_tolerance": ok}), flush=True)
        print(json.dumps({"within_tolerance": ok, "worst": worst,
                          "tol": cs.ATTN_BWD_TOL}), flush=True)

        # 2. dq and dk/dv apart at the training path's shape
        b, h, t, d = (cs.LM_BATCH, cs.GEN_MODEL["n_heads"],
                      cs.GEN_MODEL["max_len"], cs.GEN_HEAD_DIM)
        sm = 1.0 / math.sqrt(d)
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device=dev)
                       for _ in range(4))
        o, l, m = att.flash_attention(q, k, v, None, True, return_stats=True)
        ops = att.bwd_operands(q, k, v, None, o, l, m, do)
        use("new")
        _, di = att._flash_dq_cuda(*ops, True, sm)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)
        times = {"old_dq": [], "new_dq": [], "old_dkv": [], "new_dkv": [],
                 "sdpa": []}
        for i in range(args.pairs):
            for side in order(i):
                use(side)
                times[f"{side}_dq"].append(cs.cuda_time_ms(
                    lambda: att._flash_dq_cuda(*ops, True, sm), samples=5))
                times[f"{side}_dkv"].append(cs.cuda_time_ms(
                    lambda: att._flash_dkv_cuda(*ops[:4], l, m, di, do, True,
                                                sm), samples=5))
            times["sdpa"].append(cs.cuda_time_ms(
                lambda: torch.autograd.grad(lib_o, leaves, do,
                                            retain_graph=True), samples=5))
        kernels = {key: quartiles(v) for key, v in times.items()}
        for kern in ("dq", "dkv"):
            kernels[f"{kern}_new_wins"] = sum(
                n < o_ for o_, n in zip(times[f"old_{kern}"],
                                        times[f"new_{kern}"]))
        kernels["new_pair_below_sdpa"] = (
            kernels["new_dq"][1] + kernels["new_dkv"][1] < kernels["sdpa"][1])
        print(json.dumps({"shape": [b, h, t, d], **kernels}), flush=True)
        del q, k, v, do, o, l, m, ops, di, leaves, lib_o

        # 3. end to end: the LM's training step on each version in turn
        zoo = TransformerEncoder(causal=True, lm_head=True, use_kernels=True,
                                 seed=cs.GEN_SEED, **cs.GEN_MODEL)
        net = ComputationGraph(dataclasses.replace(zoo.conf(),
                                                   use_kernels=True),
                               device=dev).init()
        ds = cs.lm_dataset(torch, dev, zoo.vocab_size, cs.LM_BATCH, t,
                           cs.LM_SEED)
        steps = {"old": [], "new": []}
        for side in ("old", "new"):
            use(side)
            net.fit_batch(ds)
        for i in range(args.pairs):
            for side in order(i):
                use(side)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for _ in range(2):
                    net.fit_batch(ds)
                steps[side].append((time.monotonic() - t0) / 2 * 1e3)
    finally:
        use("new")
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "kernel": name, "within_tolerance": ok,
        **{f"{key}_ms": v for key, v in kernels.items()
           if key in times},
        "dq_new_wins": kernels["dq_new_wins"],
        "dkv_new_wins": kernels["dkv_new_wins"],
        "new_pair_below_sdpa": kernels["new_pair_below_sdpa"],
        "lm_step_old_ms": quartiles(steps["old"]),
        "lm_step_new_ms": quartiles(steps["new"]),
        "lm_step_new_wins": sum(n < o_ for o_, n in zip(steps["old"],
                                                        steps["new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


# PR 8's interface of csrc/matmul_bias_act_int8.cu: the split count, then the
# launch with an int32 [S, M, N] workspace the caller allocates
_INT8_WORKSPACE_SIGNATURES = {
    "dl4j_matmul_int8_splits": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "dl4j_matmul_bias_act_int8": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


def ab_int8(torch, args) -> int:
    """The A/B of ``matmul_bias_act_int8``. A version with the checkout's
    interface is swapped in through the loaded-library table (each side
    keeps its own plan cache); one with PR 8's workspace interface runs
    through PR 8's wrapper, which ``impls.matmul_bias_act_int8`` is set to
    while that side serves."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import build, impls
    from deeplearning4j_tpu_torch.nn import inference_opt as iopt
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.batcher import (
        BatchingConfig,
        InferenceEngine,
    )
    from deeplearning4j_tpu_torch.zoo.graphs import ResNet50
    from deeplearning4j_tpu_torch.zoo.models import AlexNet

    name = impls.INT8_SOURCE
    workspace = "dl4j_matmul_int8_splits" in args.old.read_text()
    old_lib = _build_old(build, name, args.old, _INT8_WORKSPACE_SIGNATURES
                         if workspace else impls._INT8_SIGNATURES)
    new_lib = build.load(name, impls._INT8_SIGNATURES)
    new = impls.matmul_bias_act_int8
    plans = {"old": {}, "new": {}}

    def old_workspace(xq, wq, scale, b, act):  # PR 8's wrapper
        impls._check_int8(xq, wq, scale, b, act)
        (m, k), n = xq.shape, wq.shape[1]
        y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
        splits = old_lib.dl4j_matmul_int8_splits(m, n, k, xq.device.index)
        work = (torch.empty((splits, m, n), dtype=torch.int32,
                            device=xq.device) if splits > 1 else None)
        rc = old_lib.dl4j_matmul_bias_act_int8(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
            y.data_ptr(), None if work is None else work.data_ptr(), m, n,
            k, impls.ACTIVATION_IDS[act.value], xq.device.index,
            impls.stream(xq))
        impls.raise_on_error("old matmul_bias_act_int8", rc)
        return y

    def use(side):
        impls._INT8_PLANS = plans[side]
        if workspace:
            impls.matmul_bias_act_int8 = (old_workspace if side == "old"
                                          else new)
        else:
            build._LIBS[name] = old_lib if side == "old" else new_lib

    def order(i):
        return ("old", "new") if i % 2 == 0 else ("new", "old")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    kernels = ["int8_kernel", "splitk_epilogue_kernel"]
    ok, worst, rows = True, {"old": 0, "new": 0}, []
    shapes = ([(m, k, n) for (k, n) in cs.INT8_SITES for m in cs.INT8_BUCKETS]
              + sorted(set(cs.path_shapes(ResNet50().conf(), cs.BATCH)))
              + list(cs.INT8_RAGGED))
    ident, relu = Activation("identity"), Activation("relu")
    try:
        # 1. both versions against the plain version
        for (m, k, n) in shapes:
            xq, wq, scale, b = cs._int8_operands(torch, gen, dev, m, k, n)
            ones = torch.ones(n, device=dev)
            zeros = torch.zeros(n, device=dev)
            sums = impls.matmul_bias_act_int8_plain(xq, wq, ones, zeros, ident)
            refs = {a: impls.matmul_bias_act_int8_plain(xq, wq, scale, b, a)
                    for a in (ident, relu)}
            shape = {"m": m, "k": k, "n": n}
            for side in ("old", "new"):
                use(side)
                exact = torch.equal(impls.matmul_bias_act_int8(
                    xq, wq, ones, zeros, ident), sums)
                ulps = max(cs._ulps(torch, impls.matmul_bias_act_int8(
                    xq, wq, scale, b, a), ref) for a, ref in refs.items())
                ok &= exact and ulps <= cs.INT8_MAX_ULP
                worst[side] = max(worst[side], ulps)
                shape[side] = {"sums_bitwise": exact, "max_ulps": ulps}
            print(json.dumps(shape), flush=True)
            del xq, wq, scale, b, sums, refs
        print(json.dumps({"within_tolerance": ok, "max_ulps": worst,
                          "tol_ulps": cs.INT8_MAX_ULP}), flush=True)

        # 2. per shape: AlexNet's sites with the weights from device memory,
        # then ResNet-50's 1x1 shapes and the ragged ones
        for (m, k, n) in shapes:
            copies = (max(2, -(-150 * 2 ** 20 // (k * n)))
                      if (k, n) in cs.INT8_SITES else 1)
            xq, wq, scale, b = cs._int8_operands(torch, gen, dev, m, k, n)
            wqs = [wq] + [torch.randint(-128, 128, (k, n), generator=gen,
                                        device=dev, dtype=torch.int8)
                          for _ in range(copies - 1)]
            turn = iter(range(10 ** 9))

            def call():
                return impls.matmul_bias_act_int8(
                    xq, wqs[next(turn) % copies], scale, b, relu)

            times = {"old": [], "new": []}
            for i in range(args.pairs):
                for side in order(i):
                    use(side)
                    times[side].append(cs.cuda_time_ms(call, samples=5))
            device = {}
            for side in ("old", "new"):
                use(side)
                device[side] = cs.device_ms(call, kernels)
            ops_ms, bytes_ms = cs.int8_bound_ms(m, k, n)
            row = {"m": m, "k": k, "n": n,
                   "old_ms": quartiles(times["old"]),
                   "new_ms": quartiles(times["new"]),
                   "old_device_ms": device["old"],
                   "new_device_ms": device["new"],
                   "bound_ms": max(ops_ms, bytes_ms),
                   "new_wins": sum(t_new < t_old for t_old, t_new
                                   in zip(times["old"], times["new"]))}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del xq, wq, wqs, scale, b

        # 3. end to end: the quantized AlexNet at batch 32
        zoo = AlexNet()
        image = (zoo.height, zoo.width, zoo.channels)
        net = MultiLayerNetwork(dataclasses.replace(zoo.conf(),
                                                    use_kernels=True),
                                dev).init()
        rng = np.random.default_rng(cs.INT8_SEED)
        cal = [rng.random((cs.BATCH,) + image, np.float32)
               for _ in range(cs.INT8_CAL_BATCHES)]
        q = iopt.quantize_for_inference(net, iopt.calibrate(net, cal))
        x = rng.random((cs.BATCH,) + image, np.float32)
        ends = {"forward_old": [], "forward_new": [], "images_per_s_old": [],
                "images_per_s_new": []}
        with InferenceEngine(q, BatchingConfig(max_batch=cs.BATCH)) as engine:
            with torch.inference_mode():
                x_dev = q._prepare(x)
            for i in range(args.pairs):
                for side in order(i):
                    use(side)
                    with torch.inference_mode():
                        ends[f"forward_{side}"].append(cs.cuda_time_ms(
                            lambda: q._forward(q._fwd_params(), x_dev),
                            samples=3))
                    engine.predict(x)
                    t0 = time.monotonic()
                    for _ in range(10):
                        engine.predict(x)
                    ends[f"images_per_s_{side}"].append(
                        10 * cs.BATCH / (time.monotonic() - t0))
    finally:
        use("new")
        impls._INT8_PLANS = {}
    main = [r for r in rows if r["m"] == cs.BATCH and (r["k"], r["n"])
            in cs.INT8_SITES]

    def per_forward(key):
        return sum(r[key][1] if isinstance(r[key], list) else r[key]
                   for r in main)

    print(json.dumps({
        "card": cs.nvidia_smi_line(), "kernel": name,
        "old_interface": "workspace" if workspace else "plan",
        "within_tolerance": ok, "max_ulps": worst,
        "per_forward_old_ms": per_forward("old_ms"),
        "per_forward_new_ms": per_forward("new_ms"),
        "per_forward_old_device_ms": per_forward("old_device_ms"),
        "per_forward_new_device_ms": per_forward("new_device_ms"),
        "per_forward_bound_ms": per_forward("bound_ms"),
        "shapes_new_wins": sum(r["new_wins"] for r in rows),
        "shapes_pairs": len(rows) * args.pairs,
        **{f"{key}": quartiles(v) for key, v in ends.items()},
        "forward_new_wins": sum(n_ < o_ for o_, n_ in zip(
            ends["forward_old"], ends["forward_new"])),
        "pairs": args.pairs}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
