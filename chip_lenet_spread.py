"""How often chip_smoke.py's [21] accuracy gate fails by chance, per route.

``chip_smoke.py`` [21] trains LeNet (the zoo topology, Adam 2e-3) for two
epochs on the seeded synthetic MNIST, once on the kernel route
(``use_kernels=True``) and once on the stock route, and requires both test
accuracies to reach LENET_MIN_ACC within LENET_ACC_GAP of each other.
Every fit starts from the same seeded weights and batches, so two fits of
one route on the card differ only where cuDNN's default (non-deterministic)
conv-backward algorithms sum in another order. This script repeats the fit
``--fits`` times per route under the default algorithms, and twice per
route under cuDNN's deterministic ones, and prints for each fit its test
accuracy, its last score and its largest score in the second epoch (a late
loss spike shows there), then how often the gate fails: for every pair of
a kernel-route and a stock-route fit, and for every pair of two fits of
one route.

Run from the root of a checkout, on one CUDA card::

    python3 chip_lenet_spread.py [--fits 20]

The last line is one JSON object with every number.
"""

import argparse
import itertools
import json
import sys
import time


def _gate_fails(a: float, b: float) -> bool:
    from chip_smoke import LENET_ACC_GAP, LENET_MIN_ACC

    return min(a, b) < LENET_MIN_ACC or abs(a - b) > LENET_ACC_GAP


def _share(pairs) -> dict:
    pairs = list(pairs)
    failed = sum(_gate_fails(a, b) for a, b in pairs)
    return {"pairs": len(pairs), "failed": failed,
            "share": failed / len(pairs) if pairs else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fits", type=int, default=20,
                    help="fits per route under cuDNN's default algorithms")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import build, impls

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all(impls.SOURCES)
    _, batches, test = cs.lenet_data()
    for use_kernels in (True, False):
        cs._lenet_net(torch, dev, use_kernels).fit_batch(
            next(iter(batches())))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    half = cs.LENET_TRAIN["num_examples"] // cs.LENET_TRAIN["batch"]
    out = {"card": smi, "fits": args.fits, "acc_gap": cs.LENET_ACC_GAP,
           "min_acc": cs.LENET_MIN_ACC}
    t0 = time.monotonic()
    for mode, deterministic, n in (("default", flags[0], args.fits),
                                   ("deterministic", True, 2)):
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = flags[1]
        fits = {"kernel": [], "stock": []}
        for i in range(n):
            for side, use_kernels in (("kernel", True), ("stock", False)):
                fit = cs.lenet_fit(torch, impls, dev, use_kernels, batches,
                                   test)
                sc = fit["scores"]
                fits[side].append({"accuracy": fit["accuracy"],
                                   "last_score": sc[-1],
                                   "epoch2_max_score": max(sc[half:])})
                print(f"{mode} {side} {i}: accuracy {fit['accuracy']:.4f}, "
                      f"last score {sc[-1]:.5f}, epoch-2 max score "
                      f"{max(sc[half:]):.5f}", flush=True)
        acc = {side: [f["accuracy"] for f in v] for side, v in fits.items()}
        out[mode] = {
            "fits": fits,
            "kernel_vs_stock": _share(itertools.product(acc["kernel"],
                                                        acc["stock"])),
            "kernel_vs_kernel": _share(itertools.combinations(acc["kernel"],
                                                              2)),
            "stock_vs_stock": _share(itertools.combinations(acc["stock"],
                                                            2)),
            "below_min_acc": {side: sum(a < cs.LENET_MIN_ACC for a in v)
                              for side, v in acc.items()}}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    out["seconds"] = time.monotonic() - t0
    for mode in ("default", "deterministic"):
        print(f"{mode}: gate failures kernel x stock "
              f"{json.dumps(out[mode]['kernel_vs_stock'])}, kernel x kernel "
              f"{json.dumps(out[mode]['kernel_vs_kernel'])}, stock x stock "
              f"{json.dumps(out[mode]['stock_vs_stock'])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
