"""The arithmetic of the flash backward kernels' tensor-core products, on the
CPU.

On the card, the float32 backward (``csrc/flash_attention_bwd.cu``) forms
each of its five products (s = q . k^T, dp = do . v^T, dv = p^T . do,
dq = ds . k, dk = ds^T . q) with TF32 tensor-core MMAs through the 3xTF32
split: ``big = tf32(x)``, ``small = tf32(x - big)`` and
``a . b ~ small_a . big_b + big_a . small_b + big_a . big_b``, accumulated in
f32. Here TF32 rounding is emulated in torch (round to nearest, ties away
from zero, at 13 dropped mantissa bits: ``cvt.rna.tf32.f32``), the products
of TF32 values are exact in f32, and the backward is recomputed step by step
as ``flash_attention_bwd_plain`` computes it, with each product so split.

- Through the split, dq, dk and dv stay within ``chip_smoke.py``'s
  ``ATTN_BWD_TOL["float32"]`` of ``flash_attention_bwd_plain`` and within
  ``ATTN_GRAD_F64_TOL`` of float64 autograd of ``reference_attention``: the
  tolerances the card holds the kernels to.
- With one TF32 product each (big . big only), the same inputs fall outside
  them: the reason the kernels split.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as att

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
BWD_TOL = _CS.ATTN_BWD_TOL["float32"]
F64_TOL = _CS.ATTN_GRAD_F64_TOL

# (batch, heads, Tq, Tk, head_dim, causal, seed); every case carries a seeded
# ragged length mask (lengths >= 1)
CASES = [
    (1, 2, 256, 256, 64, True, 0),
    (1, 2, 256, 256, 64, False, 1),
    (2, 2, 200, 333, 64, True, 2),
    (1, 2, 256, 256, 32, True, 3),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    """``a @ b`` in float32 from TF32 operands: 3 passes (small . big +
    big . small + big . big, the split) or 1 (big . big)."""
    a_big, b_big = tf32(a), tf32(b)
    out = a_big @ b_big
    if passes == 3:
        a_small, b_small = tf32(a - a_big), tf32(b - b_big)
        out = (a_small @ b_big + a_big @ b_small) + out
    return out


def emulated_bwd(q, k, v, km, o, l, m, do, causal, passes):
    """``flash_attention_bwd_plain``'s steps with its five products formed
    as the float32 kernels form them."""
    sm = 1.0 / q.shape[-1] ** 0.5
    mm = lambda a, b: split_matmul(a, b, passes)  # noqa: E731
    s = mm(q, k.transpose(-1, -2)) * sm
    keep = att._keep_mask(q.shape[0], q.shape[2], k.shape[2], km, causal,
                          q.device)
    s = s.masked_fill(~keep, att.NEG_INF)
    linv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    p = torch.exp(s - m[..., None]) * linv[..., None]
    di = (do * o).sum(-1, keepdim=True)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - di) * sm
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _inputs(case):
    b, h, tq, tk, d, causal, seed = case
    rng = np.random.default_rng(seed)
    q, do = (torch.tensor(rng.standard_normal((b, h, tq, d)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((b, h, tk, d)), dtype=torch.float32)
            for _ in range(2))
    lengths = rng.integers(1, tk + 1, b)
    km = torch.tensor(np.arange(tk)[None, :] < lengths[:, None],
                      dtype=torch.float32)
    o, l, m = att.flash_attention_plain(q, k, v, km, causal)
    return q, k, v, km, o, l, m, do, causal


def _outside(got, want, tol):
    atol, rtol = tol
    return int(((got.double() - want.double()).abs()
                > atol + rtol * want.double().abs()).sum())


def _f64_grads(q, k, v, km, do, causal):
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out = att.reference_attention(*leaves, km.double(), causal)
    return torch.autograd.grad(out, leaves, do.double())


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's ulp in [1, 2); 2 ulp in [2, 4)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 3.0 + 1.5 * ulp], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 3.0 + 2 * ulp],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # big + small carries x to within 2**-22 of |x|
    r = torch.tensor(np.random.default_rng(0).standard_normal(4096),
                     dtype=torch.float32)
    big = tf32(r)
    rest = (r.double() - big.double() - tf32(r - big).double()).abs()
    assert float((rest / r.double().abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_3xtf32_split_holds_the_float32_tolerances(case):
    q, k, v, km, o, l, m, do, causal = _inputs(case)
    got = emulated_bwd(q, k, v, km, o, l, m, do, causal, passes=3)
    plain = att.flash_attention_bwd_plain(q, k, v, km, o, l, m, do, causal)
    f64 = _f64_grads(q, k, v, km, do, causal)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, f64):
        assert _outside(g, p, BWD_TOL) == 0, name
        assert _outside(g, r, F64_TOL) == 0, name


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_tf32_product_falls_outside_them(case):
    q, k, v, km, o, l, m, do, causal = _inputs(case)
    got = emulated_bwd(q, k, v, km, o, l, m, do, causal, passes=1)
    plain = att.flash_attention_bwd_plain(q, k, v, km, o, l, m, do, causal)
    f64 = _f64_grads(q, k, v, km, do, causal)
    assert sum(_outside(g, p, BWD_TOL) for g, p in zip(got, plain)) > 0
    assert sum(_outside(g, r, F64_TOL) for g, r in zip(got, f64)) > 0
