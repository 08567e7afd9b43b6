"""The port's training kernels on the CPU against the JAX package.

- ``matmul_stats`` (the wrapper's plain version and its autograd Function)
  against the JAX package's two Pallas kernels for the same function,
  ``kernels.impls.matmul_stats`` and ``ops.conv_fused.matmul_with_stats``,
  run in interpret mode as ``tests/test_kernels.py`` runs them: y, the
  column sums s and sums of squares q, and the VJP for cotangents on all
  three outputs;
- ``ops.conv_fused.conv1x1_bn_stats`` (strided) against the JAX function;
- ``matmul_bias_act``'s autograd backward against ``jax.grad`` of the JAX
  kernel, as ``tests/test_kernels.py`` holds that kernel's VJP.

On the CPU the wrappers run their plain versions (the CUDA kernels are held
against those on the card by ``chip_smoke.py``). Inputs are numpy from a
seed, handed to both packages.

Tolerances: float32 throughout. y and the gradients: rtol 1e-5, atol 1e-5
(products of up to 24 terms in other orders). s and q: rtol 1e-5 relative to
sum|y| and sum(y^2) per column (the port sums the rounded y in f64, the JAX
kernel in f32 per row block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.kernels import impls as jimpls
from deeplearning4j_tpu.ops import conv_fused as jconv_fused
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import build, impls
from deeplearning4j_tpu_torch.ops import conv_fused

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)
STATS_RTOL = 1e-5

# (JAX kernel, (m, k, n)): ragged (the JAX impls kernel takes the whole
# problem as one block) and a shape the JAX conv_fused grid covers
# (m % 128 == 0)
CASES = [("impls", (37, 19, 11)), ("impls", (128, 24, 16)),
         ("conv_fused", (128, 24, 16))]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)  # [K, N]
    cts = (rng.normal(size=(m, n)).astype(np.float32),
           rng.normal(size=(n,)).astype(np.float32),
           rng.normal(size=(n,)).astype(np.float32))
    return x, w, cts


def _jax_stats(x, w, which):
    m, k = x.shape
    n = w.shape[1]
    if which == "impls":
        return lambda x_, w_: jimpls.matmul_stats(x_, w_, (m, n, k), True)
    return lambda x_, w_: jconv_fused.matmul_with_stats(x_, w_, True)


def _assert_stats_close(y, s, q, jy, js, jq):
    np.testing.assert_allclose(y, jy, **TOL)
    y64 = np.asarray(y, np.float64).reshape(-1, y.shape[-1])
    for got, want, scale in ((s, js, np.abs(y64).sum(0)),
                             (q, jq, (y64 * y64).sum(0))):
        err = np.abs(np.asarray(got, np.float64) - np.asarray(want))
        assert np.all(err <= STATS_RTOL * scale), (err / scale).max()


@pytest.mark.parametrize("which,shape", CASES)
def test_matmul_stats_forward_matches_pallas(which, shape):
    x, w, _ = _inputs(*shape, seed=1)
    jy, js, jq = (np.asarray(a) for a in
                  _jax_stats(x, w, which)(jnp.asarray(x), jnp.asarray(w)))
    y, s, q = impls.matmul_stats(torch.tensor(x), torch.tensor(w.T.copy()))
    assert y.dtype == torch.float32 and s.dtype == q.dtype == torch.float32
    assert tuple(y.shape) == jy.shape and tuple(s.shape) == js.shape
    _assert_stats_close(y.numpy(), s.numpy(), q.numpy(), jy, js, jq)


@pytest.mark.parametrize("which,shape", CASES)
def test_matmul_stats_vjp_matches_pallas_custom_vjp(which, shape):
    x, w, cts = _inputs(*shape, seed=2)
    _, vjp = jax.vjp(_jax_stats(x, w, which), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(tuple(jnp.asarray(c)
                                                  for c in cts)))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w.T.copy(), requires_grad=True)
    outs = impls.matmul_stats(xt, wt)
    assert all(o.grad_fn is not None for o in outs)
    dx, dw = torch.autograd.grad(outs, (xt, wt),
                                 tuple(torch.tensor(c) for c in cts))
    np.testing.assert_allclose(dx.numpy(), jdx, **TOL)
    np.testing.assert_allclose(dw.numpy().T, jdw, **TOL)  # [N,K] vs [K,N]


def test_matmul_stats_backward_is_the_plain_versions_gradient():
    """The Function's VJP equals autograd through the plain version, for a
    non-contiguous incoming cotangent as the NCHW view hands it on."""
    x, w, cts = _inputs(24, 8, 6, seed=3)
    gy = torch.tensor(cts[0]).T.contiguous().T  # column-major strides
    assert not gy.is_contiguous()
    grads = []
    for fn in (impls.matmul_stats, impls.matmul_stats_plain):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w.T.copy(), requires_grad=True)
        torch.autograd.backward(fn(xt, wt), (gy, torch.tensor(cts[1]),
                                             torch.tensor(cts[2])))
        grads.append((xt.grad, wt.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_matmul_stats_plain_sums_the_rounded_bf16_y():
    x, w, _ = _inputs(64, 32, 8, seed=4)
    xb = torch.tensor(x).to(torch.bfloat16)
    wb = torch.tensor(w.T.copy()).to(torch.bfloat16)
    y, s, q = impls.matmul_stats(xb, wb)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y64 = y.double()
    assert torch.equal(s, y64.sum(0).float())
    assert torch.equal(q, (y64 * y64).sum(0).float())
    # and y is the f32 product rounded once
    assert torch.equal(y, (xb.float() @ wb.float().T).to(torch.bfloat16))


def test_matmul_stats_cpu_counts_no_launch():
    x, w, _ = _inputs(8, 4, 3, seed=5)
    before = impls.matmul_stats.launches
    y, s, q = impls.matmul_stats(torch.tensor(x), torch.tensor(w.T.copy()))
    ry, rs, rq = impls.matmul_stats_plain(torch.tensor(x),
                                          torch.tensor(w.T.copy()))
    assert torch.equal(y, ry) and torch.equal(s, rs) and torch.equal(q, rq)
    assert impls.matmul_stats.launches == before


@pytest.mark.parametrize("case", ["shape", "rank", "dtype", "mixed",
                                  "device"])
def test_matmul_stats_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.zeros(4, 3), torch.zeros(5, 3)
    if case == "shape":
        w = torch.zeros(5, 2)
    elif case == "rank":
        x = torch.zeros(4, 3, 1)
    elif case == "dtype":
        x, w = x.double(), w.double()
    elif case == "mixed":
        w = w.to(torch.bfloat16)
    else:
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        impls.matmul_stats(x, w)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_conv1x1_bn_stats_matches_jax_with_gradients(stride):
    """NCHW/OIHW in the port, NHWC/HWIO in the JAX package; a strided conv
    subsamples first, and its input gradient lands on the sampled positions
    only."""
    rng = np.random.default_rng(6)
    # 2 x 16 x 16 positions: the JAX grid covers m = 512 and, strided, 128
    x = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)  # NHWC
    w = (rng.normal(size=(1, 1, 12, 16)) / 4).astype(np.float32)  # HWIO
    ho = 16 // stride[0]
    gy = rng.normal(size=(2, ho, ho, 16)).astype(np.float32)
    gs = rng.normal(size=(16,)).astype(np.float32)
    gq = rng.normal(size=(16,)).astype(np.float32)
    fn = lambda x_, w_: jconv_fused.conv1x1_bn_stats(  # noqa: E731
        x_, w_, stride, interpret=True)
    (jy, js, jq), vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp((jnp.asarray(gy), jnp.asarray(gs), jnp.asarray(gq)))

    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.tensor(np.transpose(w, (3, 2, 0, 1)).copy(),
                      requires_grad=True)
    y, s, q = conv_fused.conv1x1_bn_stats(xt, wt, stride)
    assert y.shape == (2, 16, ho, ho)
    _assert_stats_close(y.detach().permute(0, 2, 3, 1).numpy(),
                        s.detach().numpy(), q.detach().numpy(),
                        np.asarray(jy), np.asarray(js), np.asarray(jq))
    dx, dw = torch.autograd.grad(
        (y, s, q), (xt, wt), (torch.tensor(gy).permute(0, 3, 1, 2),
                              torch.tensor(gs), torch.tensor(gq)))
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx), **TOL)
    np.testing.assert_allclose(np.transpose(dw.numpy(), (2, 3, 1, 0)),
                               np.asarray(jdw), **TOL)
    if stride != (1, 1):
        skipped = dx.permute(0, 2, 3, 1).numpy()[:, 1::2]
        assert not skipped.any()


def test_fusable_is_the_jax_shape_predicate():
    for m, cin, cout in [(512, 64, 64), (6272, 256, 1024), (1568, 512, 2048),
                         (100, 64, 64), (128, 200, 64), (256, 64, 300)]:
        assert conv_fused.fusable(m, cin, cout) == \
            jconv_fused.fusable(m, cin, cout), (m, cin, cout)
        assert conv_fused.pick_block_m(m) == jconv_fused.pick_block_m(m)


@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "gelu",
                                 "sigmoid"])
def test_matmul_bias_act_backward_matches_jax_grad(act):
    m, k, n = 16, 8, 8
    rng = np.random.default_rng(7)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)

    def loss(x_, w_, b_):
        y = jimpls.matmul_bias_act(x_, w_, b_, JAct(act), (m, n, k), True)
        return jnp.sum(y ** 2)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w.T.copy(), requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    y = impls.matmul_bias_act(xt, wt, bt, Activation(act))
    assert y.grad_fn is not None
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jg[2]), rtol=1e-4,
                               atol=1e-4)


def test_matmul_bias_act_bf16_backward_keeps_dtypes():
    rng = np.random.default_rng(8)
    t = lambda a: torch.tensor(a).to(torch.bfloat16).requires_grad_()  # noqa
    x, w, b = (t(rng.normal(size=s).astype(np.float32))
               for s in ((12, 8), (4, 8), (4,)))
    y = impls.matmul_bias_act(x, w, b, Activation.RELU)
    y.float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.bfloat16
    mask = (x.detach().float() @ w.detach().float().T
            + b.detach().float() > 0).float()
    np.testing.assert_allclose(b.grad.float().numpy(),
                               mask.sum(0).numpy(), rtol=1e-2)


def test_library_digest_covers_the_shared_header(monkeypatch, tmp_path):
    for p in build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in impls.SOURCES}
    header = tmp_path / "ffma_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in impls.SOURCES:
        assert build.library_path(name) != before[name]


@pytest.mark.parametrize("layer_kind", ["conv1x1", "dense", "fused"])
def test_routed_outputs_train_like_the_stock_forward(layer_kind):
    """Every route the kernels take carries a gradient: the routed output
    has a grad_fn, and its gradients are the stock forward's."""
    from deeplearning4j_tpu_torch.conf import inputs as it
    from deeplearning4j_tpu_torch.conf.layers import DenseLayer
    from deeplearning4j_tpu_torch.conf.layers_cnn import (
        ConvolutionLayer,
        ConvolutionMode,
        FusedConvBN1x1,
    )
    from deeplearning4j_tpu_torch.kernels import routing

    gen = torch.Generator().manual_seed(9)
    if layer_kind == "dense":
        layer = DenseLayer(n_out=5, activation=Activation.TANH)
        itype, x = it.FeedForward(size=7), torch.randn(6, 7, generator=gen)
    else:
        itype = it.Convolutional(6, 6, 4)
        x = torch.randn(2, 4, 6, 6, generator=gen).contiguous(
            memory_format=torch.channels_last)
        layer = (ConvolutionLayer(n_out=5, kernel_size=(1, 1), stride=(2, 2),
                                  convolution_mode=ConvolutionMode.SAME,
                                  activation=Activation.RELU)
                 if layer_kind == "conv1x1" else
                 FusedConvBN1x1(n_out=5, stride=(2, 2),
                                activation=Activation.RELU))
    params = layer.init(gen, itype)
    state = layer.init_state(itype)
    grads = []
    for routed in (True, False):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xl = x.clone().requires_grad_()
        if routed:
            y, _ = routing.maybe_forward(layer, p, state, xl, train=True)
            assert y.grad_fn is not None
        else:
            y, _ = layer.forward(p, state, xl, train=True)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
            .backward()
        grads.append([xl.grad] + [p[k].grad for k in sorted(p)])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
