"""The port's training-mode layers, loss, updaters, schedules,
regularization and solver against the JAX package, on the CPU.

Inputs are numpy from a seed handed to both packages; layouts are
converted at the boundary (NHWC <-> NCHW, HWIO <-> OIHW, [nIn, nOut] <->
[nOut, nIn]). Tolerances, float32: layer outputs, states and gradients
rtol 1e-4, atol 1e-5 (batch statistics and their backward sum 128-512
terms in other orders); the loss and updater math rtol 1e-6 (elementwise,
the same operations); schedules rtol 1e-6 (JAX evaluates in float32, the
port in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serde as jserde
from deeplearning4j_tpu.conf import layers as jlayers
from deeplearning4j_tpu.conf import layers_cnn as jcnn
from deeplearning4j_tpu.conf import losses as jlosses
from deeplearning4j_tpu.conf import regularization as jreg
from deeplearning4j_tpu.conf import schedules as jsched
from deeplearning4j_tpu.conf import updaters as jupd
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import layers, layers_cnn, losses
from deeplearning4j_tpu_torch.conf import regularization as reg
from deeplearning4j_tpu_torch.conf import schedules, updaters
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import GradientNormalization
from deeplearning4j_tpu_torch.kernels import routing
from deeplearning4j_tpu_torch.optimize import solver

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-7)


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _layer_case(seed, shape, n_out):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(1, 1, shape[-1], n_out)) / 3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n_out).astype(np.float32)
    beta = rng.normal(0, 0.1, n_out).astype(np.float32)
    mean = rng.normal(0, 0.1, n_out).astype(np.float32)
    var = rng.uniform(0.5, 1.5, n_out).astype(np.float32)
    return x, w, gamma, beta, mean, var


# --------------------------------------------------------------------------
# FusedConvBN1x1 and BatchNormalization, train mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
@pytest.mark.parametrize("path", ["stock", "force_kernel", "routed"])
def test_fused_conv_bn_train_matches_jax(stride, path):
    """Output, the new running statistics and the gradients of the input
    and of W, gamma, beta. The JAX side runs its force_kernel path (the
    Pallas kernel in interpret mode); 2 x 16 x 16 positions give the
    kernel's grid m = 512, or 128 strided."""
    x, w, gamma, beta, mean, var = _layer_case(1, (2, 16, 16, 24), 32)
    ho = 16 // stride[0]
    gy = np.random.default_rng(2).normal(size=(2, ho, ho, 32)).astype(
        np.float32)
    jl = jcnn.FusedConvBN1x1(n_out=32, stride=stride, force_kernel=True,
                             activation=JAct.RELU)
    jp = {"W": jnp.asarray(w), "gamma": jnp.asarray(gamma),
          "beta": jnp.asarray(beta)}
    js = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def jf(p, x_):
        y, st = jl.forward(p, js, x_, train=True)
        return jnp.sum(y * gy), (y, st)

    (_, (jy, jst)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    layer = layers_cnn.FusedConvBN1x1(n_out=32, stride=stride,
                                      activation=Activation.RELU,
                                      force_kernel=path == "force_kernel")
    p = {"W": torch.tensor(np.transpose(w, (3, 2, 0, 1)).copy()),
         "gamma": torch.tensor(gamma), "beta": torch.tensor(beta)}
    p = {k: v.requires_grad_() for k, v in p.items()}
    st = {"mean": torch.tensor(mean), "var": torch.tensor(var)}
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    if path == "routed":
        y, new = routing.maybe_forward(layer, p, st, xt, train=True)
    else:
        y, new = layer.forward(p, st, xt, train=True)
    assert not new["mean"].requires_grad and not new["var"].requires_grad
    (y * _nchw(gy)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jst[k]), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(
        np.transpose(p["W"].grad.numpy(), (2, 3, 1, 0)), np.asarray(jgp["W"]),
        **TOL)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]),
                                   **TOL)


def test_fused_conv_bn_eval_is_not_routed_and_reads_running_stats():
    layer = layers_cnn.FusedConvBN1x1(n_out=4, kernel_mode="auto")
    x, w, gamma, beta, mean, var = _layer_case(3, (2, 4, 4, 3), 4)
    p = {"W": torch.tensor(np.transpose(w, (3, 2, 0, 1)).copy()),
         "gamma": torch.tensor(gamma), "beta": torch.tensor(beta)}
    st = {"mean": torch.tensor(mean), "var": torch.tensor(var)}
    assert routing.maybe_forward(layer, p, st, _nchw(x)) is None
    y, new = layer.forward(p, st, _nchw(x))
    assert new is st
    jl = jcnn.FusedConvBN1x1(n_out=4)
    jy, _ = jl.forward({"W": w, "gamma": gamma, "beta": beta},
                       {"mean": mean, "var": var}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), **TOL)
    # auto takes the kernel only on a CUDA card; force_kernel anywhere
    assert not layer._use_kernel(512, 3, torch.device("cpu"))
    assert layer._use_kernel(512, 3, torch.device("cuda"))
    forced = layers_cnn.FusedConvBN1x1(n_out=4, force_kernel=True)
    assert forced._use_kernel(512, 3, torch.device("cpu"))
    assert not forced._use_kernel(100, 3, torch.device("cpu"))  # not fusable


@pytest.mark.parametrize("rank", [4, 2])
def test_batch_norm_train_matches_jax(rank):
    shape = (4, 5, 5, 6) if rank == 4 else (16, 6)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    gy = rng.normal(size=shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta = rng.normal(0, 0.1, 6).astype(np.float32)
    jl = jcnn.BatchNormalization(activation=JAct.TANH, decay=0.8)
    js = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def jf(p, x_):
        y, st = jl.forward(p, js, x_, train=True)
        return jnp.sum(y * gy), (y, st)

    (_, (jy, jst)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
        jnp.asarray(x))

    to = _nchw if rank == 4 else torch.tensor
    back = _nhwc if rank == 4 else (lambda t: t.detach().numpy())
    layer = layers_cnn.BatchNormalization(activation=Activation.TANH,
                                          decay=0.8)
    p = {"gamma": torch.tensor(gamma, requires_grad=True),
         "beta": torch.tensor(beta, requires_grad=True)}
    xt = to(x).requires_grad_()
    y, new = layer.forward(p, {"mean": torch.zeros(6), "var": torch.ones(6)},
                           xt, train=True)
    (y * to(gy)).sum().backward()
    np.testing.assert_allclose(back(y), np.asarray(jy), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jst[k]), **TOL)
    np.testing.assert_allclose(back(xt.grad), np.asarray(jgx), **TOL)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]),
                                   **TOL)


def test_dropout_is_a_retain_probability_on_the_input():
    layer = layers.DenseLayer(n_out=3, dropout=0.75)
    x = torch.ones(64, 40)
    gen = torch.Generator().manual_seed(0)
    y = layer._dropout_input(x, True, gen)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert 0.65 < kept.float().mean() < 0.85
    # eval mode, no generator, or dropout 0: the input passes untouched
    assert layer._dropout_input(x, False, gen) is x
    assert layer._dropout_input(x, True, None) is x
    assert layers.DenseLayer(n_out=3)._dropout_input(x, True, gen) is x
    # the same generator state draws the same mask
    again = layer._dropout_input(x, True, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)


def test_output_layer_scores_pre_activations_like_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    want = jlayers.OutputLayer(n_out=4).score(
        {"W": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        jnp.asarray(labels))
    got = layers.OutputLayer(n_out=4).score(
        {"W": torch.tensor(w.T.copy()), "b": torch.tensor(b)},
        torch.tensor(x), torch.tensor(labels))
    np.testing.assert_allclose(float(got), float(want), **EXACT)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["softmax", "sigmoid"])
@pytest.mark.parametrize("extra", ["none", "weights", "mask", "time"])
def test_mcxent_score_and_gradient_match_jax(act, extra):
    rng = np.random.default_rng(6)
    shape = (5, 3, 4) if extra == "time" else (5, 4)
    z = rng.normal(size=shape).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, shape[:-1])]
    weights = [0.5, 1.0, 2.0, 1.5] if extra == "weights" else None
    mask = None
    if extra == "mask":
        mask = np.array([1, 0, 1, 1, 0], np.float32)
    elif extra == "time":
        mask = (rng.random(shape[:-1]) > 0.3).astype(np.float32)
    jloss = jlosses.LossMCXENT(weights=weights)
    jval, jgrad = jax.value_and_grad(
        lambda z_: jloss.score(jnp.asarray(labels), z_, JAct(act),
                               None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    val = losses.LossMCXENT(weights=weights).score(
        torch.tensor(labels), zt, Activation(act),
        None if mask is None else torch.tensor(mask))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), **EXACT)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


# --------------------------------------------------------------------------
# updaters and schedules
# --------------------------------------------------------------------------

UPDATERS = {
    "sgd": (updaters.Sgd(learning_rate=0.05), jupd.Sgd(learning_rate=0.05)),
    "adam": (updaters.Adam(learning_rate=0.01),
             jupd.Adam(learning_rate=0.01)),
    "nesterovs": (updaters.Nesterovs(learning_rate=0.05, momentum=0.8),
                  jupd.Nesterovs(learning_rate=0.05, momentum=0.8)),
}


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_update_leaf_matches_jax_over_steps(name):
    upd, jupd_ = UPDATERS[name]
    rng = np.random.default_rng(7)
    p = rng.normal(size=(3, 4)).astype(np.float32)
    state = upd.init_state(torch.tensor(p))
    jstate = jupd_.init_state(jnp.asarray(p))
    assert set(state) == set(jstate)
    for t in range(4):  # t is the 0-based iteration
        g = rng.normal(size=p.shape).astype(np.float32)
        lr = upd.current_lr(t, 0)
        jlr = jupd_.current_lr(t, 0)
        np.testing.assert_allclose(lr, float(jlr), **EXACT)
        u, state = upd.update_leaf(torch.tensor(g), state, lr, t)
        ju, jstate = jupd_.update_leaf(jnp.asarray(g), jstate, jlr,
                                       jnp.float32(t))
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5,
                                   atol=1e-8)
        for k in state:
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(jstate[k]), **EXACT)


def test_schedules_drive_lr_and_momentum_like_jax():
    upd = updaters.Nesterovs(
        lr_schedule=schedules.StepSchedule(initial_value=0.1, step=2.0),
        momentum_schedule=schedules.MapSchedule(values={0: 0.5, 3: 0.9}))
    jupd_ = jupd.Nesterovs(
        lr_schedule=jsched.StepSchedule(initial_value=0.1, step=2.0),
        momentum_schedule=jsched.MapSchedule(values={0: 0.5, 3: 0.9}))
    for t in range(6):
        np.testing.assert_allclose(upd.current_lr(t, 0),
                                   float(jupd_.current_lr(t, 0)), **EXACT)
        np.testing.assert_allclose(upd.current_momentum(t, 0),
                                   float(jupd_.current_momentum(t, 0)),
                                   **EXACT)


SCHEDULES = {
    "Fixed": dict(value=0.02),
    "Step": dict(initial_value=0.1, decay_rate=0.5, step=3.0),
    "Exponential": dict(initial_value=0.1, gamma=0.9),
    "Inverse": dict(initial_value=0.1, gamma=0.1, power=2.0),
    "Poly": dict(initial_value=0.1, power=2.0, max_iter=8),
    "Sigmoid": dict(initial_value=0.1, gamma=-0.5, step_size=4),
    "Map": dict(values={0: 0.1, 2: 0.05, 5: 0.01}),
    "Cycle": dict(initial_value=0.1, div_factor=10.0, cycle_length=10,
                  annealing_length=2, annealing_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES) + ["Warmup"])
@pytest.mark.parametrize("kind", ["iteration", "epoch"])
def test_schedule_value_at_matches_jax(name, kind):
    if name == "Warmup":
        port = schedules.WarmupSchedule(
            warmup_steps=3, inner=schedules.ExponentialSchedule(
                initial_value=0.1, gamma=0.9))
        ref = jsched.WarmupSchedule(
            warmup_steps=3, inner=jsched.ExponentialSchedule(
                initial_value=0.1, gamma=0.9))
    else:
        kw = dict(SCHEDULES[name])
        if name != "Fixed":
            kw["schedule_type"] = schedules.ScheduleType(kind)
        port = getattr(schedules, f"{name}Schedule")(**kw)
        if name != "Fixed":
            kw["schedule_type"] = jsched.ScheduleType(kind)
        ref = getattr(jsched, f"{name}Schedule")(**kw)
    for t in range(12):
        np.testing.assert_allclose(port.value_at(t, t // 3),
                                   float(ref.value_at(t, t // 3)),
                                   rtol=1e-6, atol=1e-9, err_msg=str(t))
    # the configuration is the JAX package's JSON
    assert serde.to_json(port) == jserde.to_json(ref)


# --------------------------------------------------------------------------
# regularization and the solver step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [m for m in GradientNormalization])
def test_normalize_layer_gradients_matches_jax(mode):
    from deeplearning4j_tpu.conf.layers import (
        GradientNormalization as JGN,
    )

    rng = np.random.default_rng(8)
    grads = {"W": rng.normal(size=(4, 3)).astype(np.float32) * 3,
             "b": rng.normal(size=(3,)).astype(np.float32)}
    port = solver.normalize_layer_gradients(
        layers.DenseLayer(gradient_normalization=mode,
                          gradient_normalization_threshold=0.5),
        {k: torch.tensor(v) for k, v in grads.items()})
    ref = jsolver.normalize_layer_gradients(
        jlayers.DenseLayer(gradient_normalization=JGN(mode.value),
                           gradient_normalization_threshold=0.5),
        {k: jnp.asarray(v) for k, v in grads.items()})
    for k in grads:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


def test_apply_updater_with_regularization_matches_jax():
    rng = np.random.default_rng(9)
    params = {"W": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    layer = layers.DenseLayer(
        regularization=(reg.L2Regularization(l2=0.1),
                        reg.WeightDecay(coeff=0.01)),
        regularization_bias=(reg.L1Regularization(l1=0.05),))
    jlayer = jlayers.DenseLayer(
        regularization=(jreg.L2Regularization(l2=0.1),
                        jreg.WeightDecay(coeff=0.01)),
        regularization_bias=(jreg.L1Regularization(l1=0.05),))
    upd, jupd_ = UPDATERS["adam"]
    tp = {k: torch.tensor(v) for k, v in params.items()}
    new_p, new_o = solver.apply_updater_to_layer(
        layer, upd, tp, {k: torch.tensor(v) for k, v in grads.items()},
        {k: upd.init_state(v) for k, v in tp.items()}, 0.01, 0)
    assert new_p["W"] is tp["W"]  # updated in place
    jp, jo = jsolver.apply_updater_to_layer(
        jlayer, jupd_, {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jupd_.init_state(jnp.asarray(v)) for k, v in params.items()},
        jnp.float32(0.01), jnp.float32(0))
    for k in params:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(new_o[k]["m"].numpy(),
                                   np.asarray(jo[k]["m"]), **EXACT)
    for r, jr in zip(layer.regularization + layer.regularization_bias,
                     jlayer.regularization + jlayer.regularization_bias):
        np.testing.assert_allclose(float(r.score_term(tp["W"])),
                                   float(jr.score_term(jp["W"])), rtol=1e-6)


def test_regularized_layer_json_loads_from_the_jax_package():
    jl = jlayers.DenseLayer(n_out=3, regularization=(
        jreg.L2Regularization(l2=0.1), jreg.WeightDecay(coeff=0.2)),
        regularization_bias=(jreg.L1Regularization(l1=0.3),))
    s = jserde.to_json(jl)
    port = serde.from_json(s)
    assert port.regularization == (reg.L2Regularization(l2=0.1),
                                   reg.WeightDecay(coeff=0.2))
    assert port.regularization_bias == (reg.L1Regularization(l1=0.3),)
    assert serde.to_json(port) == s
