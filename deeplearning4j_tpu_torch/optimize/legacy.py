"""Legacy full-batch solvers (reference ``org.deeplearning4j.optimize.
solvers``: ``LineGradientDescent``, ``ConjugateGradient``, ``LBFGS``).

Counterpart of the JAX package's ``optimize/legacy.py``, step for step:
each solver minimizes the full-batch loss as a function of one flat
params vector (search direction, backtracking Armijo line search, the
L-BFGS two-loop recursion over circular history buffers), then writes the
result back into the params. The JAX package compiles the loop into one
``lax.while_loop``; here it is a plain torch loop on the network's
device, whose conditions the host reads each iteration. A ``use_kernels``
network evaluates the loss and its gradient through its routed sites
(row 1, ``matmul_bias_act``, and its backward). The flat vector is the
network's params in sorted (layer, param) order, each flattened as the
port stores it: every step is elementwise or a dot product, so the
layout does not change the arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch


def _float_keys(net):
    return [(k, pk) for k in sorted(net.params)
            for pk in sorted(net.params[k])
            if net.params[k][pk].is_floating_point()]


def _flat_loss_fn(net, ds):
    """-> (``f(x)`` -> loss, ``vg(x)`` -> (loss, gradient), ``x0``, the
    write-back ``put(x)``) for either network class.

    The loss is evaluated in EVAL mode (``train=False``): line searches
    need a deterministic objective (dropout would break the Armijo
    condition) and BatchNorm must use the running statistics the final
    ``score`` / ``output`` will."""
    if net.params is None:
        net.init()
    keys = _float_keys(net)
    shapes = [net.params[k][pk].shape for k, pk in keys]
    sizes = [net.params[k][pk].numel() for k, pk in keys]
    if hasattr(net, "_batch_arrays"):        # MultiLayerNetwork
        features, labels, fmask, lmask = net._batch_arrays(ds)

        def loss_of(params):
            return net._loss(params, features, labels, fmask, lmask,
                             train=False)[0]
    else:                                     # ComputationGraph
        features, labels, fmasks, lmasks = net._prep_batch(ds)

        def loss_of(params):
            return net._loss(params, net.state, features, labels, fmasks,
                             lmasks, train=False)[0]

    def unflatten(x):
        params = {k: dict(vp) for k, vp in net.params.items()}
        for (k, pk), t, shape in zip(keys, torch.split(x, sizes), shapes):
            params[k][pk] = t.reshape(shape)
        return params

    def f(x):
        with torch.no_grad():
            return loss_of(unflatten(x)).detach()

    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_of(unflatten(x))
            (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), g

    def put(x):
        with torch.no_grad():
            for (k, pk), t, shape in zip(keys, torch.split(x, sizes),
                                         shapes):
                net.params[k][pk].copy_(t.reshape(shape))
        net._cast_params = None

    x0 = torch.cat([net.params[k][pk].detach().reshape(-1)
                    for k, pk in keys])
    return f, vg, x0, put


def _line_search(f, x, d, loss, g, step0, c1=1e-4, max_halvings=20):
    """Backtracking Armijo search along ``d`` (reference
    ``BackTrackLineSearch``). Returns ``(alpha, new_loss)`` as device
    scalars."""
    slope = torch.dot(g, d)
    alpha = torch.tensor(step0, dtype=x.dtype, device=x.device)
    cur = f(x + alpha * d)
    halvings = 0
    while halvings < max_halvings and bool(cur > loss + c1 * alpha * slope):
        alpha = alpha * 0.5
        cur = f(x + alpha * d)
        halvings += 1
    # a failed search (still above the Armijo bound) must not move uphill
    take = cur <= loss
    return (torch.where(take, alpha, torch.zeros_like(alpha)),
            torch.where(take, cur, loss))


@dataclasses.dataclass
class _BaseLegacySolver:
    """Shared ``optimize()``: minimize the full-batch loss, write
    the result back into the params. ``history`` holds the loss before
    the first iteration and after each one (the line search never moves
    uphill, so it never rises)."""

    max_iterations: int = 100
    tolerance: float = 1e-6
    step_size: float = 1.0

    def optimize(self, net, ds):
        f, vg, x0, put = _flat_loss_fn(net, ds)
        self.history = []
        x, loss = self._minimize(f, vg, x0)
        put(x)
        return float(loss)

    def _go_on(self, k, loss, g, done) -> bool:
        self.history.append(float(loss))
        return (k < self.max_iterations and not done
                and bool(torch.linalg.vector_norm(g) > self.tolerance))


class LineGradientDescent(_BaseLegacySolver):
    """Steepest descent + line search (reference class of the same name)."""

    def _minimize(self, f, vg, x0):
        tol, step0 = self.tolerance, self.step_size
        x = x0
        loss, g = vg(x)
        k, done = 0, False
        while self._go_on(k, loss, g, done):
            alpha, new_loss = _line_search(f, x, -g, loss, g, step0)
            x = x - alpha * g
            _, g = vg(x)
            done = bool(torch.abs(loss - new_loss) < tol)
            loss = new_loss
            k += 1
        return x, loss


class ConjugateGradient(_BaseLegacySolver):
    """Polak-Ribiere nonlinear CG with automatic restart (reference class
    of the same name)."""

    def _minimize(self, f, vg, x0):
        tol, step0 = self.tolerance, self.step_size
        x = x0
        loss, g = vg(x)
        d = -g
        k, done = 0, False
        while self._go_on(k, loss, g, done):
            alpha, new_loss = _line_search(f, x, d, loss, g, step0)
            x = x + alpha * d
            _, g2 = vg(x)
            beta = torch.clamp(
                torch.dot(g2, g2 - g)
                / torch.clamp(torch.dot(g, g), min=1e-30),
                min=0.0)  # PR+: restart (beta = 0) when the curvature turns
            d2 = -g2 + beta * d
            # a non-descent direction falls back to steepest descent
            d = torch.where(torch.dot(d2, g2) < 0, d2, -g2)
            done = bool(torch.abs(loss - new_loss) < tol)
            loss, g = new_loss, g2
            k += 1
        return x, loss


class LBFGS(_BaseLegacySolver):
    """Limited-memory BFGS (reference class of the same name): a history
    of ``m`` (s, y) pairs in circular buffers on the device and the
    two-loop recursion over them."""

    m: int = 10

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6,
                 step_size: float = 1.0, m: int = 10):
        super().__init__(max_iterations, tolerance, step_size)
        self.m = int(m)

    def _direction(self, g, S, Y, rho, k: int):
        """The two-loop recursion; entries >= k (not yet written) have
        rho = 0 and contribute nothing."""
        m = self.m
        q = g
        alphas = torch.zeros((m,), dtype=g.dtype, device=g.device)
        live = min(k, m)
        for i in range(live):
            idx = (k - 1 - i) % m
            a = rho[idx] * torch.dot(S[idx], q)
            q = q - a * Y[idx]
            alphas[idx] = a
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        if k > 0:
            newest = (k - 1) % m
            gamma = torch.dot(S[newest], Y[newest]) / torch.clamp(
                torch.dot(Y[newest], Y[newest]), min=1e-30)
        else:
            gamma = torch.ones((), dtype=g.dtype, device=g.device)
        r = gamma * q
        for i in range(live):
            idx = (k - live + i) % m
            b = rho[idx] * torch.dot(Y[idx], r)
            r = r + S[idx] * (alphas[idx] - b)
        return -r

    def _minimize(self, f, vg, x0):
        m, tol, step0 = self.m, self.tolerance, self.step_size
        n = x0.shape[0]
        x = x0
        loss, g = vg(x)
        S = x0.new_zeros((m, n))
        Y = x0.new_zeros((m, n))
        rho = x0.new_zeros((m,))
        k, done = 0, False
        while self._go_on(k, loss, g, done):
            d = self._direction(g, S, Y, rho, k)
            d = torch.where(torch.dot(d, g) < 0, d, -g)
            alpha, new_loss = _line_search(f, x, d, loss, g, step0)
            x2 = x + alpha * d
            _, g2 = vg(x2)
            s, y = x2 - x, g2 - g
            sy = torch.dot(s, y)
            if bool(sy > 1e-10):  # the curvature condition; else skip
                idx = k % m
                S[idx], Y[idx], rho[idx] = s, y, 1.0 / sy
            done = bool(torch.abs(loss - new_loss) < tol)
            x, loss, g = x2, new_loss, g2
            k += 1
        return x, loss
