"""Fused 1x1 convolution (matmul) + batch-norm statistics in one output pass.

Counterpart of the JAX package's ``deeplearning4j_tpu/ops/conv_fused.py``.
A train-mode 1x1 conv followed by batch norm otherwise writes y, reads y
back for the mean and variance, and reads it again to normalize; here the
``matmul_stats`` kernel (``csrc/matmul_stats.cu``) computes the product
AND the per-channel ``sum(y)`` / ``sum(y*y)`` in the same pass, so the
statistics read disappears. Normalization and the activation stay in
PyTorch.

The statistics are taken over the stored (storage-dtype) y, as the unfused
path reads it back; the variance is the one-pass ``E[y^2] - E[y]^2`` in
f32. The backward is the JAX package's VJP (``kernels.impls.matmul_stats``).

``bn_fold_scale_shift`` gives the inference pass (``nn.inference_opt``) the
constants of an eval-mode BN folded into the layer before it.

Layouts are the port's: activations NCHW in ``channels_last`` memory, conv
weights OIHW, and the matmul operands x [M, Cin], w [Cout, Cin] (both
Cin-contiguous, so neither is transposed).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import impls

_BM_CANDIDATES = (512, 256, 128)
_BN = 128
_BK = 128


def pick_block_m(m: int) -> Optional[int]:
    """Largest row block of the JAX kernel's grid that divides ``m`` (None:
    that grid cannot cover the shape)."""
    for bm in _BM_CANDIDATES:
        if m % bm == 0:
            return bm
    return None


def fusable(m: int, cin: int, cout: int) -> bool:
    """The JAX package's shape predicate for the fused layer path: rows
    divisible by a supported block, channel counts below the 128-wide block
    or a multiple of it. The CUDA kernel masks any shape; the predicate
    keeps ``FusedConvBN1x1``'s own kernel path on the same shapes as the
    reference's (the routed path of ``conf.use_kernels`` does not ask)."""
    return (pick_block_m(m) is not None
            and (cin <= _BK or cin % _BK == 0)
            and (cout <= _BN or cout % _BN == 0))


def matmul_with_stats(x2: torch.Tensor, w2: torch.Tensor):
    """``y = x2 @ w2.T`` plus per-output-channel ``sum(y)`` / ``sum(y*y)``
    (f32), all produced in one pass over y by the ``matmul_stats`` kernel.

    x2: [M, Cin]; w2: [Cout, Cin] -> (y [M, Cout] in x2.dtype, s [Cout],
    q [Cout]). Differentiable in x2 and w2."""
    return impls.matmul_stats(x2, w2)


def conv1x1_bn_stats(x: torch.Tensor, w: torch.Tensor,
                     stride: Tuple[int, int] = (1, 1)):
    """1x1 convolution (x NCHW, w OIHW [Cout, Cin, 1, 1], no bias) returning
    ``(y, sum, sumsq)`` with the statistics fused into the conv's output
    pass. A strided 1x1 conv is an exact spatial subsample first (VALID and
    SAME both sample positions 0, s, 2s, ...); its gradient lands back on
    those positions through the slice."""
    sh, sw = stride
    if (sh, sw) != (1, 1):
        x = x[:, :, ::sh, ::sw]
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    # NCHW in channels_last memory: the NHWC permute is the memory order, so
    # [M, Cin] is a view unless the stride subsample left gaps
    x2 = x.permute(0, 2, 3, 1).reshape(b * h * wd, cin).contiguous()
    y2, s, q = matmul_with_stats(x2, w.reshape(cout, cin).contiguous())
    return y2.view(b, h, wd, cout).permute(0, 3, 1, 2), s, q


def bn_fold_scale_shift(gamma, beta, mean, var, eps):
    """Inference-time BN folding constants: eval-mode batch norm is the
    per-channel affine ``y*scale + shift`` with ``scale = gamma /
    sqrt(var + eps)`` and ``shift = beta - mean * scale``, so a preceding
    linear op (identity activation) absorbs it: ``W' = W * scale`` over the
    output channels, ``b' = b * scale + shift``. Computed in float32
    whatever the serving dtype, in the JAX package's operation order.
    ``gamma``/``beta`` None = locked gamma/beta (1/0)."""
    var32 = torch.as_tensor(var).float()
    mean32 = torch.as_tensor(mean).float()
    scale = torch.rsqrt(var32 + eps)
    if gamma is not None:
        scale = scale * torch.as_tensor(gamma).float()
    shift = -mean32 * scale
    if beta is not None:
        shift = shift + torch.as_tensor(beta).float()
    return scale, shift
