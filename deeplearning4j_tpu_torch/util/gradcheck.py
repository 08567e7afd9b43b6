"""Gradient check: the port's own correctness oracle.

Reference: ``org.deeplearning4j.gradientcheck.GradientCheckUtil``;
counterpart of the JAX package's ``util/gradcheck.py``, with the same
protocol and defaults: central differences against backprop in float64,
compared parameter by parameter with the relative error
``|a - n| / (|a| + |n|)``, a failure where it passes ``max_rel_error`` and
the absolute error passes ``abs_error_threshold``.

The analytic side is ``torch.autograd`` through the network's own loss
(train mode, no dropout: the same ``_loss`` that ``fit`` differentiates).
The network is built in float64 on ``device`` (the card unless the caller
asks for the CPU, as the networks' own default) with ``use_kernels`` off:
the hand-written kernels take float32 and bfloat16 only, as the JAX
package's float64 network runs without its Pallas kernels. Flat indices in
a result index the reference's params vector (``params_flat``: the JAX
package's order and layouts), and the checked vector is that vector, so a
sampled index names the same weight in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util import params as params_util
from deeplearning4j_tpu_torch.util.convert import layout_perm


@dataclasses.dataclass
class GradCheckResult:
    n_params: int
    n_checked: int
    n_failed: int
    max_rel_error: float
    mean_rel_error: float
    failures: list  # (flat_index, analytic, numeric, rel_error)

    @property
    def passed(self) -> bool:
        return self.n_failed == 0

    def summary(self) -> str:
        return (f"{self.n_failed} of {self.n_checked} checked (of "
                f"{self.n_params}) failed; max rel error "
                f"{self.max_rel_error:.3e}, mean {self.mean_rel_error:.3e}; "
                f"first failures {self.failures[:5]}")


def _central_diff_check(f, flat0: torch.Tensor, analytic: np.ndarray,
                        idx: np.ndarray, epsilon: float,
                        max_rel_error: float,
                        abs_error_threshold: float) -> GradCheckResult:
    """Perturb each sampled entry of the float64 vector ``flat0`` by
    ``+-epsilon``, evaluate ``f`` (a scalar function of the vector) twice,
    and compare the central difference with ``analytic``."""
    numeric = np.empty(len(idx), np.float64)
    with torch.no_grad():
        for j, i in enumerate(idx):
            v = flat0.clone()
            v[i] += epsilon
            up = float(f(v))
            v[i] -= 2.0 * epsilon
            dn = float(f(v))
            numeric[j] = (up - dn) / (2.0 * epsilon)
    a = np.asarray(analytic, np.float64)[np.asarray(idx)]
    denom = np.abs(a) + np.abs(numeric)
    rel = np.where(denom > 0, np.abs(a - numeric) / np.maximum(denom, 1e-300),
                   0.0)
    bad = (rel > max_rel_error) & (np.abs(a - numeric) > abs_error_threshold)
    failures = [(int(i), float(av), float(nv), float(rv))
                for i, av, nv, rv in zip(np.asarray(idx)[bad], a[bad],
                                         numeric[bad], rel[bad])]
    return GradCheckResult(
        n_params=int(flat0.numel()),
        n_checked=len(idx),
        n_failed=len(failures),
        max_rel_error=float(np.max(rel)) if len(rel) else 0.0,
        mean_rel_error=float(np.mean(rel)) if len(rel) else 0.0,
        failures=failures[:20],
    )


def _params_of_flat(conf, flat: torch.Tensor, like):
    """The params dict ``like`` rebuilt from ``flat`` (``params_flat``'s
    layout) as differentiable views: each chunk reshaped in the JAX
    package's layout and permuted into the port's."""
    out = {k: dict(vp) for k, vp in like.items()}
    pos = 0
    for k in params_util._conf_keys(conf, like):
        owner, layer = params_util._param_owner(conf, k)
        for name in owner.param_order():
            if name not in like[k]:
                continue
            t = like[k][name]
            n = t.numel()
            perm = layout_perm(layer, name, t.ndim)
            if perm is None:
                out[k][name] = flat[pos:pos + n].reshape(t.shape)
            else:
                jshape = tuple(t.shape[i] for i in perm)
                out[k][name] = flat[pos:pos + n].reshape(jshape).permute(
                    *np.argsort(perm).tolist())
            pos += n
    return out


def _sample(n: int, n_samples, seed) -> np.ndarray:
    if n_samples is not None and n_samples < n:
        rng = np.random.default_rng(seed)
        return np.sort(rng.choice(n, size=n_samples, replace=False))
    return np.arange(n)


def _check_net_params_gradient(net, loss_of, epsilon, max_rel_error,
                               abs_error_threshold, n_samples,
                               seed) -> GradCheckResult:
    """The MultiLayerNetwork / ComputationGraph check: the loss as a
    function of the flat float64 params vector, its gradient by autograd,
    then central differences at the sampled indices."""
    conf = net.conf

    def loss_from_flat(flat):
        return loss_of(_params_of_flat(conf, flat, net.params))

    flat0 = torch.from_numpy(
        np.asarray(net.params_flat(), np.float64)).to(net.device)
    leaf = flat0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss_from_flat(leaf), leaf)
    analytic = grad.detach().cpu().numpy()
    idx = _sample(flat0.numel(), n_samples, seed)
    return _central_diff_check(loss_from_flat, flat0, analytic, idx,
                               epsilon, max_rel_error, abs_error_threshold)


def gradient_check(conf, ds, epsilon: float = 1e-6,
                   max_rel_error: float = 1e-5,
                   abs_error_threshold: float = 1e-9,
                   n_samples: Optional[int] = None,
                   seed: int = 0, device: str = "cuda") -> GradCheckResult:
    """Check d(loss)/d(params) of a MultiLayerConfiguration against central
    differences (reference ``GradientCheckUtil#checkGradients``), on a
    float64 network initialized from ``conf.seed`` on ``device``.
    ``n_samples``: check a random subset of the params (None = all)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf64 = dataclasses.replace(conf, dtype="float64", compute_dtype=None,
                                 use_kernels=False)
    net = MultiLayerNetwork(conf64, device=device).init()
    features, labels, fmask, lmask = net._batch_arrays(ds)

    def loss_of(params):
        loss, _ = net._loss(params, features, labels, fmask, lmask,
                            train=True)
        return loss

    return _check_net_params_gradient(net, loss_of, epsilon, max_rel_error,
                                      abs_error_threshold, n_samples, seed)


def check_layer_input_gradient(layer, input_type, x, epsilon: float = 1e-6,
                               max_rel_error: float = 1e-5,
                               abs_error_threshold: float = 1e-9,
                               seed: int = 0,
                               device: str = "cuda") -> GradCheckResult:
    """Op-level check (reference ``OpValidation``): d(sum(layer(x)))/dx
    against central differences in float64, eval mode, on ``device``, on
    params drawn from ``seed`` (on the CPU, as the networks draw theirs, so
    a seed gives the same weights on every device). ``x`` is in the JAX
    package's layout (NHWC for an image); flat indices index it raveled."""
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.to(device)
              for k, v in layer.init(gen, input_type, torch.float64).items()}
    state = {k: v.to(device)
             for k, v in layer.init_state(input_type, torch.float64).items()}
    x_np = np.asarray(x, np.float64)

    def f(flat):
        xx = flat.reshape(x_np.shape)
        if xx.ndim == 4:  # NHWC -> the port's logical NCHW
            xx = xx.permute(0, 3, 1, 2)
        y, _ = layer.forward(params, state, xx, train=False)
        return torch.sum(y)

    flat0 = torch.from_numpy(x_np.ravel().copy()).to(device)
    leaf = flat0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(f(leaf), leaf)
    return _central_diff_check(f, flat0, grad.cpu().numpy(),
                               np.arange(flat0.numel()), epsilon,
                               max_rel_error, abs_error_threshold)


def gradient_check_graph(conf, mds, epsilon: float = 1e-6,
                         max_rel_error: float = 1e-5,
                         abs_error_threshold: float = 1e-9,
                         n_samples: Optional[int] = None,
                         seed: int = 0,
                         device: str = "cuda") -> GradCheckResult:
    """Gradient check of a ComputationGraphConfiguration (reference
    ``GradientCheckUtil#checkGradients(GraphConfig)``), the same float64
    protocol as :func:`gradient_check` on ``device``; ``mds`` a DataSet or
    MultiDataSet."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf64 = dataclasses.replace(conf, dtype="float64", compute_dtype=None,
                                 use_kernels=False)
    net = ComputationGraph(conf64, device=device).init()
    features, labels, fmasks, lmasks = net._prep_batch(mds)

    def loss_of(params):
        loss, _ = net._loss(params, net.state, features, labels, fmasks,
                            lmasks, train=True)
        return loss

    return _check_net_params_gradient(net, loss_of, epsilon, max_rel_error,
                                      abs_error_threshold, n_samples, seed)
