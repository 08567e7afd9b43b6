"""The arithmetic of the tensor-core flash forward and GEMM, on the CPU.

On the card, the float32 flash forward (``csrc/flash_attention.cu``, head
sizes up to 128) forms its two products per key tile, s = q . k^T and
o += p . v, and ``matmul_bias_act`` (``csrc/matmul_bias_act.cu`` on
``csrc/tc_gemm.cuh``) its product x . w^T, with TF32 tensor-core MMAs
through the 3xTF32 split: ``big = tf32(a)``, ``small = tf32(a - big)`` and
``a . b ~ small_a . big_b + big_a . small_b + big_a . big_b``, accumulated in
f32. Here the TF32 rounding of ``tests/test_torch_flash_bwd_split.py`` is
applied to the same products in torch, and the forward runs key tile by key
tile with the kernel's online softmax (the running max, the rescale of l and
of o, o divided by l once at the end).

- Through the split, o, l and m stay within ``chip_smoke.py``'s
  ``ATTN_TOL["float32"]`` of ``flash_attention_plain``, and the GEMM within
  ``KERNEL_TOL["float32"]`` of ``matmul_bias_act_plain`` at ResNet-50's 1x1
  shapes with M scaled down: the tolerances the card holds the kernels to.
- With one TF32 product each (big . big only), the same inputs fall outside
  them: the reason the kernels split.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import impls
from deeplearning4j_tpu_torch.ops import attention as att

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _load("chip_smoke", ROOT.parent / "chip_smoke.py")
_BWD = _load("_flash_bwd_split", ROOT / "test_torch_flash_bwd_split.py")
split_matmul = _BWD.split_matmul
ATTN_TOL = _CS.ATTN_TOL["float32"]
GEMM_TOL = _CS.KERNEL_TOL["float32"]

# (batch, heads, Tq, Tk, head_dim, causal, seed); every case carries a seeded
# ragged length mask (lengths >= 1)
FLASH_CASES = [
    (1, 2, 256, 256, 64, True, 0),
    (1, 2, 256, 256, 64, False, 1),
    (2, 2, 200, 333, 64, True, 2),
    (1, 2, 256, 256, 32, True, 3),
    (1, 2, 128, 128, 128, True, 4),
]

# ResNet-50's 15 distinct 1x1 shapes at batch 32 (chip_smoke's path_shapes),
# M cut 64-fold (at least 16 rows): K and N, which set the sums, as on the card
RESNET_1X1 = [
    (100352, 64, 64), (100352, 64, 256), (100352, 256, 64),
    (25088, 256, 128), (25088, 128, 512), (25088, 256, 512),
    (25088, 512, 128), (6272, 512, 256), (6272, 256, 1024),
    (6272, 512, 1024), (6272, 1024, 256), (1568, 1024, 512),
    (1568, 512, 2048), (1568, 1024, 2048), (1568, 2048, 512),
]
GEMM_CASES = [(max(16, m // 64), k, n) for m, k, n in RESNET_1X1]


def key_tile(d: int) -> int:
    """The forward kernel's staged key tile (``FwdCfg<T, DP>::BN``)."""
    return 32 if d <= 64 else 16


def emulated_fwd(q, k, v, km, causal, passes):
    """``(o, l, m)`` as the float32 tensor-core forward forms them: key tile
    by key tile, s = q . k^T through the split, scaled and masked; the
    online softmax in f32; o += p . v through the split (p unrounded).
    ``passes``: 3 (the split), 1 (one TF32 product) or 0 (plain f32
    products, no TF32)."""
    sm = 1.0 / math.sqrt(q.shape[-1])
    keep = att._keep_mask(q.shape[0], q.shape[2], k.shape[2], km, causal,
                          q.device)
    b, h, tq, d = q.shape
    m = torch.full((b, h, tq), att.NEG_INF, dtype=torch.float32)
    l = torch.zeros((b, h, tq), dtype=torch.float32)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32)
    bn = key_tile(d)

    def mm(a, b_):
        return a @ b_ if passes == 0 else split_matmul(a, b_, passes)

    for j0 in range(0, k.shape[2], bn):
        kt, vt = k[:, :, j0:j0 + bn], v[:, :, j0:j0 + bn]
        s = mm(q, kt.transpose(-1, -2)) * sm
        s = s.masked_fill(~keep[..., j0:j0 + bn], att.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    return acc / torch.where(l == 0, torch.ones_like(l), l)[..., None], l, m


def _flash_inputs(case):
    b, h, tq, tk, d, causal, seed = case
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((b, h, tq, d)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((b, h, tk, d)),
                         dtype=torch.float32) for _ in range(2))
    lengths = rng.integers(1, tk + 1, b)
    km = torch.tensor(np.arange(tk)[None, :] < lengths[:, None],
                      dtype=torch.float32)
    return q, k, v, km, causal


def _outside(got, want, tol):
    atol, rtol = tol
    return int(((got.double() - want.double()).abs()
                > atol + rtol * want.double().abs()).sum())


def _flash_outside(case, passes):
    q, k, v, km, causal = _flash_inputs(case)
    got = emulated_fwd(q, k, v, km, causal, passes)
    ref = att.flash_attention_plain(q, k, v, km, causal)
    return {key: _outside(g, r, ATTN_TOL[key])
            for key, g, r in zip(("o", "l", "m"), got, ref)}


def _gemm(case, seed=0):
    m, k, n = case
    rng = np.random.default_rng(seed + m + k + n)
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((n, k)) / math.sqrt(k),
                     dtype=torch.float32)
    b = torch.tensor(0.1 * rng.standard_normal(n), dtype=torch.float32)
    return x, w, b


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_the_3xtf32_split_forward_holds_attn_tol(case):
    assert _flash_outside(case, passes=3) == {"o": 0, "l": 0, "m": 0}


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_one_tf32_product_forward_falls_outside_attn_tol(case):
    outside = _flash_outside(case, passes=1)
    assert outside["o"] > 0 and outside["m"] > 0, outside


@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_the_3xtf32_split_gemm_holds_kernel_tol(case):
    x, w, b = _gemm(case)
    got = split_matmul(x, w.T, passes=3) + b
    ref = impls.matmul_bias_act_plain(x, w, b, Activation("identity"))
    assert _outside(got, ref, GEMM_TOL) == 0


@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_one_tf32_product_gemm_falls_outside_kernel_tol(case):
    x, w, b = _gemm(case)
    got = split_matmul(x, w.T, passes=1) + b
    ref = impls.matmul_bias_act_plain(x, w, b, Activation("identity"))
    assert _outside(got, ref, GEMM_TOL) > 0


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_the_forward_emulation_without_tf32_is_the_plain_forward(case):
    """Without TF32 rounding the tile-by-tile online softmax computes
    ``flash_attention_plain``'s function up to f32 summation order, far
    inside the tolerances: what falls outside them with one TF32 product is
    the rounding, not the emulation."""
    q, k, v, km, causal = _flash_inputs(case)
    got = emulated_fwd(q, k, v, km, causal, passes=0)
    ref = att.flash_attention_plain(q, k, v, km, causal)
    for key, g, r in zip(("o", "l", "m"), got, ref):
        atol, rtol = ATTN_TOL[key]
        assert _outside(g, r, (atol / 10, rtol / 10)) == 0, key
