#!/usr/bin/env python3
"""Phase [33] of ``chip_smoke.py``: fine-tuning a pretrained model on one
H100 under the training health layer, with full-width AlexNet fine-tuned
on row 1 (``matmul_bias_act``).

Float32 throughout, seeded, the pretrained cache (``DL4J_TPU_HOME``) a
temporary directory.

- (a) Publish and restore: full-width AlexNet (224x224x3, 1000 classes,
  seeded weights) published with ``save_pretrained`` and restored with
  ``AlexNet().init_pretrained(PretrainedType.IMAGENET)`` on the card, the
  params bit-identical; the artifact with one byte flipped refused with
  the checksum ``IOError``. A 7x7-stem ResNet-50 artifact (seeded BN)
  through ``restore_partial`` into ``ResNet50(num_classes=10)`` with the
  space-to-depth stem: only the head skipped, and on row 1's 36 sites
  (``use_kernels``) the target's global-pool activations those of the
  donor within [22]'s ``FEATURE_RTOL``.
- (b) Fine-tune: the restored AlexNet with ``use_kernels`` through
  ``TransferLearning.Builder``: frozen through its last pooling layer
  (index 9), a 10-class head, ``FineTuneConfiguration(Adam(1e-4),
  dropout 0, seed)``. ``EarlyStoppingTrainer`` with
  ``ScoreImprovementEpochTerminationCondition`` +
  ``MaxEpochsTerminationCondition`` + ``DivergenceTerminationCondition``
  and a ``ClassificationScoreCalculator`` on a held-out set, over a seeded
  10-class set of class templates plus noise (640 training and 160
  held-out images, batch 32) made on the card: a template is a 7x7x3
  uniform draw upsampled bilinearly to 224x224 (pixel-level templates
  under noise of their own size do not survive the random frozen convs'
  pooling: the head stayed near chance for 4 epochs in a rehearsal on
  the CPU's features). Gates: the frozen convs'
  SHA-256 unchanged; row 1 launched twice a step and twice an evaluation
  forward over the kernel route's fit (fc6 and fc7; 0 in the frozen
  stack), as ``routed_sites`` predicts; the step-1 gradients of the
  kernel route against ``use_kernels=False`` from the same params within
  ``TRANSFER_GRAD_REL_L2`` and, with row 1's operands rounded to TF32
  (``chip_zoo.one_pass_row1``), outside it; the best model's held-out
  accuracy above 0.5 (chance 0.1). The routes' held-out logits, losses
  and accuracies a epoch are reported beside the control's, not held:
  Adam turns a rounding-level difference into a full step of a weight
  (a ReLU unit alive on one route and dead on the other moves its 6400
  weights by the rate), and the routes part chaotically, differently a
  seed (``--spread 3`` on an H100 80GB HBM3 at 700 W: the held-out
  logits 4e-7 to 7e-2 apart by epoch 5, the control's 6e-2 to 1.3e-1),
  as [31c]'s did over 3 steps.
- (c) ``TransferLearningHelper``: each training batch featurized once,
  then ``fit_featurized`` for the kernel route's steps in the same order:
  the tail's moves against (b)'s within ``HELPER_REL_L2``.
- (d) Health, a ``FaultPlan`` corrupting ``train.step`` at call
  ``POISON_CALL``: SKIP_STEP leaves params, updater state and layer state
  bit-identical across it (``skipped_steps`` 1); WARN and SKIP_STEP make
  no more synchronizing calls a step than the unguarded step (counted
  with ``torch.cuda.set_sync_debug_mode("warn")``); ROLLBACK restores the
  last-good snapshot bit for bit; row 1 keeps a NaN input's NaN through
  its clamping epilogues, as its plain version does, and the NaN CUDA
  arithmetic makes (0x7fffffff) in every output of its row; HALT raises
  ``DivergenceError`` and its
  bundle's five files parse with a strict ``parse_constant``; an
  early-stopping run under SKIP_STEP stops on the planted step with
  ``TerminationReason.ITERATION``, naming
  ``DivergenceTerminationCondition``.
- (e) Timings: the fine-tune step per route (host clock, the device's
  kernel time and the idle share), the guard's added ms a step under WARN
  and SKIP_STEP, one ROLLBACK snapshot (ms, bytes), ``featurize`` ms a
  batch, and row 1 at fc6 (32, 6400, 4096, relu) and fc7 (32, 4096, 4096,
  relu) beside its plain version, ``F.linear`` + relu and the bounds.

``python3 chip_transfer.py`` builds the kernels and runs [33] alone;
``--spread N`` instead reads (b)'s route errors at N seeds, the readings
``TRANSFER_GRAD_REL_L2`` comes from.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import tempfile
import time
import warnings

import numpy as np

import chip_smoke as cs

TRANSFER_SEED = 33
CLASSES = 10
HW = 224
FC6_K = 6400  # pool5's 5x5x256 at 224x224
TRAIN_N, HELD_N, BATCH = 640, 160, 32
TEMPLATE_CELLS = 7  # a template: 7x7x3 uniform in [0, 1), upsampled
NOISE = 0.5  # the per-pixel noise's std
FROZEN_THROUGH = 9  # AlexNet's last pooling layer
LR = 1e-4
MAX_EPOCHS, PATIENCE = 5, 2
BEST_ACCURACY = 0.5
POISON_CALL = 3  # the corrupted train.step call (1-based)
SYNC_STEPS = 5
GUARD_PAIRS, GUARD_STEPS = 3, 10
# the routes' step-1 gradients, relative L2 over the trained layers (kernel
# route against use_kernels=False; ``--spread 3`` on an H100 80GB HBM3 at
# 700 W, seeds 33-35: 6.1e-7 to 7.2e-7, with one TF32 product a term
# 9.1e-3 to 1.5e-2)
TRANSFER_GRAD_REL_L2 = 1e-4
# the helper's tail moves against the full network's, relative L2: the
# same float32 ops on the same features
HELPER_REL_L2 = 1e-5


def _log(msg: str) -> None:
    cs.log(msg)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _deterministic(torch):
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def _equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(torch, a[k], b[k])
                                            for k in a)
    return bool(torch.equal(a, b))


def _training_state(net):
    return _copy({"params": net.params, "opt": net.opt_state,
                  "state": net.state})


# --------------------------------------------------------------------------
# (a) publish and restore
# --------------------------------------------------------------------------

def publish_and_restore(torch, dev, smi) -> tuple:
    """(a): AlexNet published and restored bit for bit, a flipped byte
    refused, and ResNet-50's 7x7 stem restored into the s2d stem."""
    from deeplearning4j_tpu_torch.zoo import (
        AlexNet,
        PretrainedType,
        ResNet50,
        restore_partial,
        save_pretrained,
    )
    from deeplearning4j_tpu_torch.zoo import pretrained as zp

    t0 = time.monotonic()
    model = AlexNet()
    src = model.init(dev)
    t1 = time.monotonic()
    path = save_pretrained(src, model.model_name, PretrainedType.IMAGENET)
    publish_s = time.monotonic() - t1
    t1 = time.monotonic()
    net = AlexNet().init_pretrained(PretrainedType.IMAGENET, device=dev)
    restore_s = time.monotonic() - t1
    if net.device != src.device or not _equal(torch, net.params, src.params):
        raise AssertionError("[33a] the restored AlexNet's params are not "
                             "the published ones bit for bit")
    n_params = net.num_params()
    del src
    # one flipped byte: the sidecar's checksum refuses the artifact
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        AlexNet().init_pretrained(PretrainedType.IMAGENET, device=dev)
        raise AssertionError("[33a] a corrupted artifact loaded")
    except IOError as e:
        if "checksum mismatch" not in str(e):
            raise
        refused = str(e)[:80]
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(byte)
    if zp.sha256_of(path) != path.with_suffix(".zip.sha256").read_text(
            ).strip():
        raise AssertionError("[33a] the artifact did not come back")
    # a 7x7-stem ResNet-50 into the space-to-depth stem, row 1's 36 sites
    t1 = time.monotonic()
    donor_model = ResNet50()
    donor = donor_model.init(dev)
    cs.randomize_bn(donor, TRANSFER_SEED)
    rpath = save_pretrained(donor, "ResNet50_7x7", PretrainedType.IMAGENET)
    target_model = ResNet50(num_classes=CLASSES)
    target_model.stem_space_to_depth = True
    target = target_model.init(dev)
    loaded, skipped = restore_partial(rpath, target)
    partial_s = time.monotonic() - t1
    if skipped != ["output/W", "output/b"] or "stem_conv/W" not in loaded:
        raise AssertionError(f"[33a] restore_partial skipped {skipped}")
    feats = []
    x = cs._synthetic_batch(ResNet50(), cs.S2D_BATCH,
                            TRANSFER_SEED).features
    cs.reset_launch_counts()
    for g in (donor, target):
        g.conf = dataclasses.replace(g.conf, use_kernels=True)
        with torch.inference_mode():
            acts, _ = g._forward(g._fwd_params(), g.state,
                                 g._prepare([x]), skip={"output"})
            feats.append(acts["avgpool"].float().cpu())
    launches = cs.launch_counts()["matmul_bias_act"]
    if launches != 2 * 36:
        raise AssertionError(f"[33a] row 1 launched {launches} times over "
                             f"the two ResNet-50 forwards, not 72")
    feat_err = float((feats[1] - feats[0]).abs().max()
                     / feats[0].abs().max())
    if not feat_err <= cs.FEATURE_RTOL:
        raise AssertionError(f"[33a] the s2d target's pooled features "
                             f"differ from the 7x7 donor's by {feat_err:.3e}"
                             f" of their max (tol {cs.FEATURE_RTOL})")
    del donor, target
    row = {"alexnet_params": n_params, "zip_mib": size / 2 ** 20,
           "publish_s": publish_s, "restore_s": restore_s,
           "refused": refused, "resnet_loaded": len(loaded),
           "resnet_skipped": skipped, "resnet_partial_s": partial_s,
           "resnet_feature_rel_err": feat_err,
           "resnet_row1_launches": launches,
           "seconds": time.monotonic() - t0}
    _log(f"[33a] AlexNet {n_params:,} params published ({size / 2**20:.0f} "
         f"MB, {publish_s:.1f} s) and restored on the card bit for bit "
         f"({restore_s:.1f} s); a flipped byte refused ({refused}...); "
         f"ResNet-50 7x7 -> s2d: {len(loaded)} loaded, skipped {skipped}, "
         f"pooled features {feat_err:.3e} of their max (tol "
         f"{cs.FEATURE_RTOL}) over row 1's 36 sites [{smi}]")
    return row, net


# --------------------------------------------------------------------------
# (b) the fine-tune
# --------------------------------------------------------------------------

def transfer_data(torch, dev, seed=TRANSFER_SEED):
    """The training and held-out batches (lists of ``DataSet``s on the
    card): ``CLASSES`` seeded templates (``TEMPLATE_CELLS`` squared cells
    of 3 colours uniform in [0, 1), upsampled bilinearly) plus Gaussian
    noise of std ``NOISE`` a pixel, one-hot labels, images NHWC."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    g = torch.Generator(device=dev).manual_seed(seed)
    cells = torch.rand((CLASSES, 3, TEMPLATE_CELLS, TEMPLATE_CELLS),
                       generator=g, device=dev)
    templates = torch.nn.functional.interpolate(
        cells, size=(HW, HW), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    out = []
    for n in (TRAIN_N, HELD_N):
        y = torch.randint(0, CLASSES, (n,), generator=g, device=dev)
        x = templates[y] + NOISE * torch.randn((n, HW, HW, 3), generator=g,
                                               device=dev)
        onehot = torch.nn.functional.one_hot(y, CLASSES).float()
        out.append([DataSet(x[i:i + BATCH], onehot[i:i + BATCH])
                    for i in range(0, n, BATCH)])
    return out


def fine_tune_conf(base, seed=TRANSFER_SEED):
    """The transferred network of ``base`` (AlexNet with ``use_kernels``):
    frozen through index 9, a ``CLASSES``-way head."""
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
    from deeplearning4j_tpu_torch.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration,
        TransferLearning,
    )

    return (TransferLearning.Builder(base)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=Adam(LR), dropout=0.0, seed=seed))
            .set_feature_extractor(FROZEN_THROUGH)
            .remove_output_layer()
            .add_layer(OutputLayer(n_out=CLASSES,
                                   activation=Activation.SOFTMAX,
                                   loss_fn=LossMCXENT()))
            .build())


def _twin(net, use_kernels=None, params=None):
    """A copy of ``net`` (its conf with ``use_kernels`` replaced), on
    ``params`` (default: its own), with a fresh updater."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = net.conf if use_kernels is None else dataclasses.replace(
        net.conf, use_kernels=use_kernels)
    return MultiLayerNetwork(conf, net.device).set_params(
        params if params is not None else net.params, net.state)


def early_stopping_fit(torch, net, train, held):
    """(b)'s ``EarlyStoppingTrainer`` run on ``net``: the result and the
    held-out loss of every evaluated epoch."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )

    class Calculator(es.ClassificationScoreCalculator):
        """The negated accuracy, and the held-out loss and logits beside
        it."""

        losses: list
        logits: list

        def calculate_score(self, model):
            self.losses.append(es.DataSetLossCalculator(
                self.iterator).calculate_score(model))
            self.logits.append(held_logits(torch, model, held))
            return super().calculate_score(model)

    calc = Calculator(ListDataSetIterator(held))
    calc.losses, calc.logits = [], []
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            es.ScoreImprovementEpochTerminationCondition(PATIENCE),
            es.MaxEpochsTerminationCondition(MAX_EPOCHS)],
        iteration_termination_conditions=[
            es.DivergenceTerminationCondition()],
        score_calculator=calc)
    t0 = time.monotonic()
    result = es.EarlyStoppingTrainer(cfg, net,
                                     ListDataSetIterator(train)).fit()
    torch.cuda.synchronize()
    return result, calc, time.monotonic() - t0


def held_logits(torch, net, held):
    """The output layer's pre-activation over the held-out batches, float64
    on the host."""
    last = len(net.conf.layers) - 1
    out = []
    with torch.no_grad():
        for ds in held:
            x, _ = net._run(net._fwd_params(), net.state,
                            net._prepare(ds.features), upto=last)
            out.append(net.conf.layers[last].pre_output(
                net.params[str(last)], x).double().cpu())
    return torch.cat(out)


def _frozen_digest(net) -> str:
    h = hashlib.sha256()
    for i in range(FROZEN_THROUGH + 1):
        for name, t in sorted(net.params.get(str(i), {}).items()):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _grad_rel_l2(torch, ga, gb) -> float:
    """Relative L2 of gradients ``ga`` against ``gb``, all tensors
    together (the frozen layers' are zero in both)."""
    num = den = 0.0
    for k in gb:
        for p, b in gb[k].items():
            a, b = ga[k][p].double(), b.double()
            num += float(((a - b) ** 2).sum())
            den += float((b * b).sum())
    return math.sqrt(num / max(den, 1e-300))


def step1_errors(torch, tuned, p0, ds) -> tuple:
    """The step-1 gradients from ``p0`` on ``ds``: the kernel route's and,
    with row 1's operands rounded to TF32, the control's, each against
    ``use_kernels=False`` (relative L2)."""
    import chip_zoo

    gs, _ = _twin(tuned, use_kernels=False,
                  params=p0).compute_gradient_and_score(ds)
    kernel = _twin(tuned, params=p0)
    gk, _ = kernel.compute_gradient_and_score(ds)
    with chip_zoo.one_pass_row1(torch):
        gc, _ = kernel.compute_gradient_and_score(ds)
    return _grad_rel_l2(torch, gk, gs), _grad_rel_l2(torch, gc, gs)


def _route_errors(torch, ka, kb) -> list:
    """Per common evaluated epoch: the logits' relative L2 and the loss's
    relative error of ``ka`` against ``kb`` (two calculators)."""
    return [(float(torch.linalg.vector_norm(a - b)
                   / torch.linalg.vector_norm(b)), _rel(la, lb))
            for a, b, la, lb in zip(ka.logits, kb.logits, ka.losses,
                                    kb.losses)]


def fine_tune(torch, dev, base, smi, seed=TRANSFER_SEED) -> tuple:
    """(b): the kernel route's early-stopping fine-tune (the main path,
    counted), the stock route's and the one-TF32-product control's."""
    import chip_zoo
    from deeplearning4j_tpu_torch.kernels import impls, routing

    train, held = transfer_data(torch, dev, seed)
    tuned = fine_tune_conf(base, seed)
    sites = routing.routed_sites(tuned.conf, BATCH, mode="cuda")
    shapes = [(e.m, e.k, e.n, e.act) for _, _, e in sites]
    if [s for s, _, _ in sites] != ["11", "12"] or shapes != [
            (BATCH, FC6_K, 4096, "relu"), (BATCH, 4096, 4096, "relu")]:
        raise AssertionError(f"[33b] routed sites {sites}")
    p0 = _copy(tuned.params)
    digest = _frozen_digest(tuned)
    grad_err, grad_ctl = step1_errors(torch, tuned, p0, train[0])
    stock = _twin(tuned, use_kernels=False, params=p0)
    control = _twin(tuned, params=p0)
    # ---- the main path: counts from here on belong to it ----
    cs.reset_launch_counts()
    res, calc, fit_s = early_stopping_fit(torch, tuned, train, held)
    launches = cs.launch_counts()["matmul_bias_act"]
    by_shape = dict(impls.matmul_bias_act.shapes)
    # ---- end of the main path ----
    steps = tuned.iteration
    evaluations = len(res.score_vs_epoch)
    want = 2 * (steps + 3 * len(held) * evaluations)
    if launches != want or set(by_shape) != set(shapes) \
            or len(set(by_shape.values())) != 1:
        raise AssertionError(f"[33b] row 1 launched {launches} times "
                             f"({by_shape}) over {steps} steps and "
                             f"{evaluations} evaluations; expected {want}, "
                             f"half at each of {shapes}")
    if _frozen_digest(tuned) != digest:
        raise AssertionError("[33b] the frozen convs moved")
    sres, scalc, stock_s = early_stopping_fit(torch, stock, train, held)
    with chip_zoo.one_pass_row1(torch):
        cres, ccalc, _ = early_stopping_fit(torch, control, train, held)
    err, ctl = _route_errors(torch, calc, scalc), _route_errors(torch, ccalc,
                                                                scalc)
    best = res.get_best_model()
    acc = best.evaluate(_iterator(held)).accuracy()
    row = {"seed": seed, "steps": steps, "epochs": res.total_epochs,
           "termination": res.termination_details,
           "best_epoch": res.best_model_epoch,
           "accuracy_kernel": [-s for s in res.score_vs_epoch.values()],
           "accuracy_stock": [-s for s in sres.score_vs_epoch.values()],
           "held_loss_kernel": calc.losses, "held_loss_stock": scalc.losses,
           "held_loss_one_pass": ccalc.losses,
           "grad_rel_l2": grad_err, "grad_rel_l2_one_pass": grad_ctl,
           "route_errors": err, "one_pass_errors": ctl,
           "best_accuracy": acc,
           "launches": launches, "routed_sites": len(sites),
           "by_shape": {str(k): v for k, v in by_shape.items()},
           "fit_s_kernel": fit_s, "fit_s_stock": stock_s,
           "frozen_sha256": digest[:16], "sites": shapes}
    return row, tuned, stock, p0, train, held


def _iterator(batches):
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )

    return ListDataSetIterator(batches)


def check_fine_tune(row, smi) -> None:
    if not row["grad_rel_l2"] <= TRANSFER_GRAD_REL_L2 < row[
            "grad_rel_l2_one_pass"]:
        raise AssertionError(
            f"[33b] step-1 gradients against the stock route: kernel "
            f"{row['grad_rel_l2']:.3e}, one TF32 product a term "
            f"{row['grad_rel_l2_one_pass']:.3e} (tol {TRANSFER_GRAD_REL_L2}:"
            f" the first within, the second outside)")
    if not row["best_accuracy"] > BEST_ACCURACY:
        raise AssertionError(f"[33b] the best model's held-out accuracy is "
                             f"{row['best_accuracy']:.3f}")
    _log(f"[33b] AlexNet fine-tune (frozen through {FROZEN_THROUGH}, "
         f"Adam({LR}), batch {BATCH}, {TRAIN_N} / {HELD_N} images): "
         f"{row['steps']} steps over {row['epochs']} epochs "
         f"({row['termination']}), held-out accuracy a epoch kernel "
         f"{row['accuracy_kernel']} stock {row['accuracy_stock']}, best "
         f"{row['best_accuracy']:.3f} (epoch {row['best_epoch']}); step-1 "
         f"gradients kernel vs stock {row['grad_rel_l2']:.3e} (tol "
         f"{TRANSFER_GRAD_REL_L2}; one TF32 product a term "
         f"{row['grad_rel_l2_one_pass']:.3e}); held-out logits and losses a "
         f"epoch kernel vs stock {row['route_errors']}, one TF32 product "
         f"{row['one_pass_errors']}; row 1 {row['launches']} "
         f"launches ({row['routed_sites']} sites, 2 a step and 2 an "
         f"evaluation forward; {row['by_shape']}); frozen convs unchanged; "
         f"fit "
         f"{row['fit_s_kernel']:.1f} s kernel route, "
         f"{row['fit_s_stock']:.1f} s stock [{smi}]")


# --------------------------------------------------------------------------
# (c) TransferLearningHelper
# --------------------------------------------------------------------------

def helper_fit(torch, tuned, p0, train, steps: int, smi) -> dict:
    """(c): featurize once, ``fit_featurized`` for ``steps`` steps in the
    kernel route's order, the tail's moves against the full network's."""
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearningHelper,
    )

    net = _twin(tuned, params=p0)
    helper = TransferLearningHelper(net)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    feats = [helper.featurize(ds) for ds in train]
    torch.cuda.synchronize()
    featurize_s = time.monotonic() - t0
    t0 = time.monotonic()
    for i in range(steps):
        helper.fit_featurized(feats[i % len(feats)])
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    num = den = 0.0
    bitwise = True
    for k in (str(i) for i in range(FROZEN_THROUGH + 1, len(net.conf.layers))):
        for p, v in tuned.params.get(k, {}).items():
            a = (net.params[k][p] - p0[k][p]).double()
            b = (v - p0[k][p]).double()
            num += float(((a - b) ** 2).sum())
            den += float((b * b).sum())
            bitwise = bitwise and bool(torch.equal(net.params[k][p], v))
    rel = math.sqrt(num / max(den, 1e-300))
    if not rel <= HELPER_REL_L2:
        raise AssertionError(f"[33c] the helper's tail moved {rel:.3e} "
                             f"from the full network's (tol "
                             f"{HELPER_REL_L2})")
    featurize_ms = cs.cuda_time_ms(lambda: helper.featurize(train[0]))
    _log(f"[33c] TransferLearningHelper: {len(train)} batches featurized "
         f"once ({featurize_s:.2f} s; one batch {featurize_ms:.3f} ms), "
         f"{steps} fit_featurized steps ({fit_s:.2f} s): the tail's moves "
         f"{rel:.3e} from the full network's (tol {HELPER_REL_L2}; "
         f"bitwise {bitwise}) [{smi}]")
    return {"steps": steps, "featurize_s": featurize_s,
            "featurize_ms": featurize_ms, "fit_s": fit_s,
            "tail_rel_l2": rel, "bitwise": bitwise}


# --------------------------------------------------------------------------
# (d) health
# --------------------------------------------------------------------------

def _sync_count(torch, net, batches) -> int:
    """Synchronizing calls over ``_fit_batch`` on ``batches`` (the
    warnings of ``set_sync_debug_mode("warn")``; each one is logged)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for ds in batches:
                net._fit_batch(ds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    found = [w for w in caught if "synchroniz" in str(w.message)]
    for w in found:
        _log(f"[33d] sync: {str(w.message)[:120]} ({w.filename}:{w.lineno})")
    return len(found)


def _poisoned_steps(torch, net, train, n, check):
    """``fit_batch`` on the first ``n`` batches with ``train.step``
    corrupted at ``POISON_CALL``; ``check(before, net)`` right after it."""
    from deeplearning4j_tpu_torch.resilience.faults import FaultPlan

    plan = FaultPlan().inject("train.step", on_calls=[POISON_CALL],
                              action="corrupt")
    with plan.armed():
        for i, ds in enumerate(train[:n]):
            before = _training_state(net) if i == POISON_CALL - 1 else None
            net.fit_batch(ds)
            if before is not None:
                check(before, net)
    if plan.fired("train.step") != 1:
        raise AssertionError("[33d] the fault did not fire once")


def _strict_json(path, name):
    def bare(c):
        raise AssertionError(f"[33d] bare {c} literal in {name}")

    text = open(os.path.join(path, name)).read()
    for doc in (filter(None, text.splitlines()) if name.endswith(".jsonl")
                else [text]):
        json.loads(doc, parse_constant=bare)


def health_checks(torch, tuned, p0, train, smi) -> dict:
    """(d): the four policies on the fine-tune, and the guard's cost."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
    from deeplearning4j_tpu_torch.telemetry import flightrec, health

    out = {"nan_kept": nan_propagation(torch, tuned.device)}
    try:
        # WARN and SKIP_STEP: no more synchronizing calls than unguarded
        net = _twin(tuned, params=p0)
        net.fit_batch(train[0])
        _sync_count(torch, net, train[1:2])  # the debug mode's first use
        syncs = {}
        for mode in ("none", "warn", "skip_step"):
            if mode == "none":
                health.disable()
            else:
                health.configure(mode, flush_every=1000)
            syncs[mode] = _sync_count(torch, net,
                                      train[1:1 + SYNC_STEPS]) / SYNC_STEPS
        if not (syncs["warn"] <= syncs["none"]
                and syncs["skip_step"] <= syncs["none"]):
            raise AssertionError(f"[33d] synchronizing calls a step: "
                                 f"{syncs}")
        out["syncs_per_step"] = syncs
        # the guard's added time a step, modes in alternating turns
        times = {m: [] for m in syncs}
        order = list(syncs)
        for i in range(GUARD_PAIRS):
            for mode in (order if i % 2 == 0 else order[::-1]):
                if mode == "none":
                    health.disable()
                else:
                    health.configure(mode, flush_every=1000)
                net._fit_batch(train[0])
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for j in range(GUARD_STEPS):
                    net._fit_batch(train[1 + j % (len(train) - 1)])
                torch.cuda.synchronize()
                times[mode].append((time.monotonic() - t0) / GUARD_STEPS
                                   * 1e3)
        step_ms = {m: statistics.median(v) for m, v in times.items()}
        out["step_ms"] = step_ms
        out["guard_added_ms"] = {m: step_ms[m] - step_ms["none"]
                                 for m in ("warn", "skip_step")}
        health.MONITOR.reset()

        # SKIP_STEP: bit-identical across the poisoned step
        def same(before, n):
            if not _equal(torch, _training_state(n), before):
                raise AssertionError("[33d] SKIP_STEP changed the training "
                                     "state on the poisoned step")

        health.configure("skip_step", flush_every=1000)
        _poisoned_steps(torch, _twin(tuned, params=p0), train,
                        POISON_CALL + 1, same)
        rep = health.report()
        if rep["skipped_steps"] != 1 or rep["nonfinite_steps"] != 1:
            raise AssertionError(f"[33d] SKIP_STEP report {rep}")
        out["skip_step"] = {k: rep[k] for k in ("steps", "nonfinite_steps",
                                                "skipped_steps")}
        # ROLLBACK: the last-good snapshot bit for bit
        health.configure("rollback", snapshot_every=1)
        rnet = _twin(tuned, params=p0)
        _poisoned_steps(torch, rnet, train, POISON_CALL, same)
        if health.MONITOR.rollbacks != 1:
            raise AssertionError("[33d] ROLLBACK did not restore")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        snap = rnet._health_snapshot()
        snap_ms = (time.monotonic() - t0) * 1e3
        nbytes = sum(a.nbytes for tree in ("params", "state", "opt_state")
                     for a in _leaves(snap[tree]))
        out["rollback"] = {"rollbacks": health.MONITOR.rollbacks,
                           "snapshot_ms": snap_ms, "snapshot_bytes": nbytes}
        del snap, rnet
        # HALT: DivergenceError and a bundle of five strict JSON files
        with tempfile.TemporaryDirectory() as d, \
                _env(DL4J_FLIGHTREC_DIR=d):
            health.configure("halt")
            hnet = _twin(tuned, params=p0)
            plan = FaultPlan().inject("train.step", on_calls=[POISON_CALL],
                                      action="corrupt")
            try:
                with plan.armed():
                    hnet.fit(_iterator(train[:POISON_CALL + 1]))
                raise AssertionError("[33d] HALT did not raise")
            except health.DivergenceError as e:
                halt_step = e.step
            bundle = flightrec.RECORDER.last_bundle
            files = sorted(os.listdir(bundle))
            if files != ["manifest.json", "metrics.json", "records.jsonl",
                         "trace.json", "traces.json"]:
                raise AssertionError(f"[33d] the bundle holds {files}")
            for name in files:
                _strict_json(bundle, name)
            n_records = json.load(open(os.path.join(
                bundle, "manifest.json")))["n_records"]
        if halt_step != POISON_CALL:
            raise AssertionError(f"[33d] HALT at step {halt_step}")
        out["halt"] = {"step": halt_step, "bundle_files": files,
                       "records": n_records}
        # an early-stopping run stops on the planted step
        health.configure("skip_step", flush_every=1000)
        enet = _twin(tuned, params=p0)
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(MAX_EPOCHS)],
            iteration_termination_conditions=[
                es.DivergenceTerminationCondition()])
        plan = FaultPlan().inject("train.step", on_calls=[POISON_CALL],
                                  action="corrupt")
        with plan.armed():
            res = es.EarlyStoppingTrainer(cfg, enet, _iterator(train)).fit()
        if res.termination_reason is not es.TerminationReason.ITERATION \
                or "DivergenceTerminationCondition" not in \
                res.termination_details or enet.iteration != POISON_CALL:
            raise AssertionError(f"[33d] early stopping ended "
                                 f"{res.termination_reason}: "
                                 f"{res.termination_details} at iteration "
                                 f"{enet.iteration}")
        out["early_stopping"] = {"reason": res.termination_reason.value,
                                 "details": res.termination_details,
                                 "iteration": enet.iteration}
    finally:
        health.disable()
        health.MONITOR.reset()
        flightrec.RECORDER.disable().reset()
    _log(f"[33d] health on the fine-tune, train.step corrupted at call "
         f"{POISON_CALL}: row 1 keeps a host NaN through "
         f"{out['nan_kept']['activations']}, the NaN CUDA arithmetic makes "
         f"in {out['nan_kept']['cuda_nan_rows_kept']} of "
         f"{out['nan_kept']['cuda_nan_row_width']} outputs; "
         f"SKIP_STEP bit-identical ({out['skip_step']}); "
         f"synchronizing calls a step {out['syncs_per_step']}; ROLLBACK bit "
         f"for bit (snapshot {out['rollback']['snapshot_ms']:.1f} ms, "
         f"{out['rollback']['snapshot_bytes'] / 2**20:.0f} MiB); HALT at "
         f"step {out['halt']['step']}, bundle of {len(out['halt']['bundle_files'])} "
         f"strict JSON files; early stopping: "
         f"{out['early_stopping']['details']}; step ms {out['step_ms']} "
         f"(guard added {out['guard_added_ms']}) [{smi}]")
    return out


def nan_propagation(torch, dev) -> dict:
    """Row 1 at fc7's shape with a NaN (0x7fc00000, the host's) in its
    input: every clamping epilogue keeps the NaN row, as the plain version
    does, and the other rows agree within ``KERNEL_TOL``. Held too: the NaN
    CUDA arithmetic makes (0x7fffffff) survives the 3xTF32 split
    (``mma_tiles.cuh::split_tf32``) in every output of its row. Returns
    the activations held and the count of that row's NaN outputs."""
    from deeplearning4j_tpu_torch.conf.activations import Activation
    from deeplearning4j_tpu_torch.kernels import impls

    gen = torch.Generator(device=dev).manual_seed(TRANSFER_SEED)
    x = torch.randn((BATCH, 4096), generator=gen, device=dev)
    w = torch.randn((4096, 4096), generator=gen, device=dev) / 64.0
    b = 0.1 * torch.randn((4096,), generator=gen, device=dev)
    x[0, 0] = float("nan")
    atol, rtol = cs.KERNEL_TOL["float32"]
    names = ["relu", "relu6", "hardsigmoid", "hardtanh", "rectifiedtanh"]
    for name in names:
        act = Activation(name)
        y = impls.matmul_bias_act(x, w, b, act)
        ref = impls.matmul_bias_act_plain(x, w, b, act)
        if not (torch.equal(torch.isnan(y), torch.isnan(ref))
                and bool(torch.isnan(y[0]).all())
                and bool(torch.allclose(y[1:], ref[1:], atol=atol,
                                        rtol=rtol))):
            raise AssertionError(f"[33d] row 1's {name} epilogue: "
                                 f"{int(torch.isnan(y).sum())} NaN outputs "
                                 f"against the plain version's "
                                 f"{int(torch.isnan(ref).sum())}")
    x.view(torch.int32)[0, 0] = 0x7FFFFFFF
    y = impls.matmul_bias_act(x, w, b, Activation.IDENTITY)
    kept = int(torch.isnan(y[0]).sum())
    if kept != y.shape[1]:
        raise AssertionError(f"[33d] row 1 kept the 0x7fffffff NaN in "
                             f"{kept} of {y.shape[1]} outputs")
    return {"activations": names, "cuda_nan_rows_kept": kept,
            "cuda_nan_row_width": int(y.shape[1])}


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def transfer_phase(torch, F, dev, smi) -> tuple:
    """[33]: returns the ``{"transfer": ...}`` line and row 1's
    ``transfer`` entry for the kernels line."""
    import chip_zoo

    t_start = time.monotonic()
    with tempfile.TemporaryDirectory() as home, _env(DL4J_TPU_HOME=home), \
            _deterministic(torch):
        pub, restored = publish_and_restore(torch, dev, smi)
        torch.cuda.empty_cache()
        base = _twin(restored, use_kernels=True)
        del restored
        row, tuned, stock, p0, train, held = fine_tune(torch, dev, base,
                                                       smi)
        del base
        check_fine_tune(row, smi)
        helper = helper_fit(torch, tuned, p0, train, row["steps"], smi)
        health_row = health_checks(torch, tuned, p0, train, smi)
        prof = {"kernel": cs._profile_steps(torch, _twin(tuned, params=p0),
                                            train[0], 10),
                "stock": cs._profile_steps(torch, stock, train[0], 10)}
        turns = cs.mln_step_times(torch, {"kernel": _twin(tuned, params=p0),
                                          "stock": stock}, train[0],
                                  pairs=3, steps=10)
        del tuned, stock, train, held
        torch.cuda.empty_cache()
    fc6, fc7 = row.pop("sites")
    half = row["launches"] // 2
    shape_rows = chip_zoo.time_zoo_shapes(
        torch, F, dev, [("AlexNet fc6",) + tuple(fc6) + (1, half),
                        ("AlexNet fc7",) + tuple(fc7) + (1, half)], "33e")
    wall = time.monotonic() - t_start
    _log(f"[33e] fine-tune step kernel route {turns['step_ms_kernel']:.2f} "
         f"ms, stock {turns['step_ms_stock']:.2f} ms (alternating turns); "
         f"device {prof['kernel']['device_ms']:.2f} / "
         f"{prof['stock']['device_ms']:.2f} ms, idle share "
         f"{prof['kernel']['idle_share']:.3f} / "
         f"{prof['stock']['idle_share']:.3f} [{smi}]")
    _log(f"[33] fine-tuning under the health layer in {wall:.1f} s [{smi}]")
    row1 = {
        "launches": row["launches"],
        "scope": ("[33b]: AlexNet's fc6 / fc7 over the kernel route's "
                  "early-stopping fine-tune at batch 32 (2 a step, 2 an "
                  "evaluation forward), as counted; shapes: launches as "
                  "counted there, times of one float32 launch at a time; "
                  "library = F.linear then relu"),
        "shapes": shape_rows,
    }
    line = {"card": smi, "seconds": wall, "publish": pub, "fine_tune": row,
            "helper": helper, "health": health_row,
            "step": {"turns": turns, "profile": prof}}
    return line, row1


def spread(torch, dev, n, smi) -> dict:
    """(b)'s route errors at ``n`` seeds (data and head), no gate: the
    readings ``TRANSFER_GRAD_REL_L2`` is set from."""
    from deeplearning4j_tpu_torch.zoo import AlexNet

    base = _twin(AlexNet().init(dev), use_kernels=True)
    out = {"grad": [], "grad_one_pass": [], "route": [], "one_pass": [],
           "accuracy": []}
    with _deterministic(torch):
        for seed in range(TRANSFER_SEED, TRANSFER_SEED + n):
            row = fine_tune(torch, dev, base, smi, seed)[0]
            out["grad"].append(row["grad_rel_l2"])
            out["grad_one_pass"].append(row["grad_rel_l2_one_pass"])
            out["route"].append(row["route_errors"])
            out["one_pass"].append(row["one_pass_errors"])
            out["accuracy"].append(row["best_accuracy"])
            _log(f"[33 spread] seed {seed}: step-1 gradients kernel vs "
                 f"stock {row['grad_rel_l2']:.3e}, one TF32 product "
                 f"{row['grad_rel_l2_one_pass']:.3e}; held-out logits and "
                 f"losses a "
                 f"epoch kernel vs stock {row['route_errors']}, one TF32 "
                 f"product {row['one_pass_errors']}, best accuracy "
                 f"{row['best_accuracy']:.3f}, epochs {row['epochs']} "
                 f"[{smi}]")
            torch.cuda.empty_cache()
    return out


def main() -> int:
    """The build and [33] alone, or ``--spread N``."""
    import argparse
    import sys

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="read the route errors at N seeds instead")
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
        _log(json.dumps({"transfer_spread": spread(torch, dev, args.spread,
                                                   smi), "card": smi}))
        return 0
    line, row1 = transfer_phase(torch, F, dev, smi)
    _log(json.dumps({"transfer": line, "row1": row1}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
