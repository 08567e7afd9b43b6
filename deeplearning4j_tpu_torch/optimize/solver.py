"""Gradient post-processing + updater application — the solver step.

Reference: ``org.deeplearning4j.optimize.solvers.BaseOptimizer`` (gradient
normalization/clipping per layer conf) and ``org.deeplearning4j.nn.updater``
(regularization, then the layer's updater); counterpart of the JAX
package's ``optimize/solver.py``. The network calls these under
``torch.no_grad()`` after ``loss.backward()``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.conf.layers import GradientNormalization


def normalize_layer_gradients(layer_conf, grads: dict) -> dict:
    """Apply the layer's GradientNormalization (reference
    ``BaseOptimizer#postProcessGradient``)."""
    gn = getattr(layer_conf, "gradient_normalization", None)
    thr = getattr(layer_conf, "gradient_normalization_threshold", 1.0)
    if not grads or gn is None or gn is GradientNormalization.NONE:
        return grads
    if gn is GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / (torch.linalg.norm(g) + 1e-12) for k, g in grads.items()}
    if gn is GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-24)
        return {k: g / norm for k, g in grads.items()}
    if gn is GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -thr, thr) for k, g in grads.items()}
    if gn is GradientNormalization.CLIP_L2_PER_LAYER:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-24)
        scale = torch.clamp(thr / norm, max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if gn is GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        return {k: g * torch.clamp(thr / (torch.linalg.norm(g) + 1e-12),
                                   max=1.0)
                for k, g in grads.items()}
    raise ValueError(f"unhandled GradientNormalization {gn}")


def normalize_layer_slices(layer_conf, grads: dict, sq: dict) -> dict:
    """:func:`normalize_layer_gradients` on flat slices of the layer's
    gradients (the ZeRO step's), with each full tensor's squared sum in
    ``sq`` ({param key: sum of squares over every rank's slices})."""
    gn = layer_conf.gradient_normalization
    thr = getattr(layer_conf, "gradient_normalization_threshold", 1.0)
    if gn is GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -thr, thr) for k, g in grads.items()}
    if gn is GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / (torch.sqrt(sq[k]) + 1e-12) for k, g in grads.items()}
    lnorm = torch.sqrt(sum(sq.values()) + 1e-24)
    if gn is GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        return {k: g / lnorm for k, g in grads.items()}
    if gn is GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(thr / lnorm, max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if gn is GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        return {k: g * torch.clamp(thr / (torch.sqrt(sq[k]) + 1e-12),
                                   max=1.0)
                for k, g in grads.items()}
    raise ValueError(f"unhandled GradientNormalization {gn}")


def apply_updater_to_layer(layer_conf, updater, params: dict, grads: dict,
                           opt_state: dict, lr, t, epoch=0.0):
    """Regularization (before/after the updater) + the updater transform
    for ONE layer; returns ``(new_params, new_opt_state)``.

    Reference flow (``UpdaterBlock#update``): L1/L2 added to the gradient
    -> ``GradientUpdater#applyUpdater`` -> WeightDecay added to the update
    -> ``params -= update``. The subtraction is in place (each param tensor
    keeps its storage and memory format), so ``new_params`` holds the same
    tensors as ``params``.
    """
    reg_w = tuple(getattr(layer_conf, "regularization", ()) or ())
    reg_b = tuple(getattr(layer_conf, "regularization_bias", ()) or ())
    reg_keys = set(layer_conf.regularized_param_keys())
    new_params, new_opt = {}, {}
    for k, p in params.items():
        g = grads[k]
        regs = reg_w if k in reg_keys else reg_b
        for r in regs:
            g = r.apply_before_updater(g, p, lr)
        upd, new_opt[k] = updater.update_leaf(g, opt_state[k], lr, t,
                                              epoch=epoch, param=p)
        for r in regs:
            upd = r.apply_after_updater(upd, p, lr)
        new_params[k] = p.sub_(upd)
    return new_params, new_opt


def regularization_score(params: dict, layer_of):
    """Total regularization penalty added to the reported score (reference
    ``BaseLayer#calcRegularizationScore``): ``layer_of(key)`` is the layer
    conf whose ``regularization`` / ``regularization_bias`` apply to the
    params under ``key``."""
    total = 0.0
    for key, lparams in params.items():
        conf = layer_of(key)
        reg_keys = set(conf.regularized_param_keys())
        for k, p in lparams.items():
            regs = (getattr(conf, "regularization", ()) if k in reg_keys
                    else getattr(conf, "regularization_bias", ()))
            for r in regs or ():
                total = total + r.score_term(p)
    return total


def apply_updates(net, grads: dict, t, epoch=0.0) -> None:
    """The update pass of one step on a network: for each layer, its
    gradient normalization, regularization and updater
    (``net._layer_updater(key)`` gives the layer conf and updater),
    applied to ``net.params`` in place. Every updater and regularizer is
    elementwise, so the same call on flat slices of params, gradients and
    updater state (the ZeRO step) gives the same bits element for
    element."""
    with torch.no_grad():
        for k in grads:
            layer, upd = net._layer_updater(k)
            g = normalize_layer_gradients(layer, grads[k])
            net.params[k], net.opt_state[k] = apply_updater_to_layer(
                layer, upd, net.params[k], g, net.opt_state[k],
                upd.current_lr(t, epoch), t, epoch)
