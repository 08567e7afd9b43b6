"""The port's attention ops against the JAX package's, on the CPU.

The plain tiers (reference, blockwise, decode, cache_update) are held to
their JAX counterparts; ``flash_attention_plain`` to the JAX Pallas flash
forward (``_flash_fwd_impl``, interpret mode, 32-wide blocks as
``tests/test_attention.py`` runs it: o, l and m); and
``paged_decode_attention_plain`` to the JAX Pallas paged decode kernel in
interpret mode. On the CPU each wrapper runs its plain version; the CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``. Inputs are made with numpy from a seed.

Tolerances: float32 — both packages sum in f32 in different orders over
at most a few hundred terms: atol = rtol = 2e-5 (``tests/test_attention.py``
holds the Pallas kernels to the reference at the same). bfloat16 — both
round p and o to bf16 (2**-8 relative) at points that differ by an f32
rounding, so one bf16 ulp of the output's magnitude: atol = rtol = 2e-2.
Rows with no valid key average over whatever keys a kernel visits, so
only their finiteness is compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu_torch.ops import attention as att

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _qkv(seed, b=2, h=3, tq=40, tk=40, d=16, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    if lengths is None:
        km = (rng.random((b, tk)) > 0.2).astype(np.float32)
        km[:, 0] = 1.0
    else:
        km = (np.arange(tk)[None, :] < np.asarray(lengths)[:, None]
              ).astype(np.float32)
    return q, k, v, km


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,tq,tk", [(False, 40, 40), (True, 40, 40),
                                          (True, 24, 56)])
def test_reference_attention_matches_jax(causal, tq, tk):
    q, k, v, km = _qkv(1, tq=tq, tk=tk)
    ref = np.asarray(jatt.reference_attention(*_j(q, k, v, km), causal))
    got = att.reference_attention(*_t(q, k, v, km), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("causal,tq,tk", [(False, 40, 40), (True, 40, 40),
                                          (True, 24, 56)])
def test_blockwise_attention_matches_jax(causal, tq, tk):
    q, k, v, km = _qkv(2, tq=tq, tk=tk)
    ref = np.asarray(jatt.blockwise_attention(*_j(q, k, v, km), causal,
                                              block_k=16))
    got = att.blockwise_attention(*_t(q, k, v, km), causal=causal,
                                  block_k=16)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def _caches(seed, b=5, s=32, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, kc, vc


# slot 0, the last slot of a page, the first of the next, the last slot
# of the cache, and past it (the whole cache is attended)
POSITIONS = np.asarray([0, 7, 8, 31, 40], np.int32)


def test_decode_attention_matches_jax():
    q, kc, vc = _caches(3)
    ref = np.asarray(jatt.decode_attention(*_j(q, kc, vc, POSITIONS)))
    got = att.decode_attention(*_t(q, kc, vc), torch.tensor(POSITIONS))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("t", [1, 3])
def test_cache_update_matches_jax_including_the_clamp(t):
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((4, 8, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, t, 2, 3)).astype(np.float32)
    # in range, the last legal start, and two past it (clamped to 8 - t)
    pos = np.asarray([0, 8 - t, 7, 100], np.int32)
    ref = np.asarray(jatt.cache_update(*_j(cache, new, pos)))
    c = torch.tensor(cache)
    out = att.cache_update(c, torch.tensor(new), torch.tensor(pos))
    assert out is c  # written in place
    np.testing.assert_array_equal(c.numpy(), ref)


def _jax_flash(q, k, v, km, causal, dtype=jnp.float32):
    o, l, m = jatt._flash_fwd_impl(
        *(jnp.asarray(a, dtype) for a in (q, k, v)),
        None if km is None else jnp.asarray(km), causal, None, 32, 32, True)
    return (np.asarray(o.astype(jnp.float32)), np.asarray(l), np.asarray(m))


def _valid_rows(km, tq, tk, causal, b=2):
    """[B, Tq] rows with at least one valid key."""
    keep = np.ones((b, tq, tk), bool) if km is None \
        else np.broadcast_to(km[:, None, :] > 0, (km.shape[0], tq, tk))
    if causal:
        keep = keep & (np.arange(tk)[None, :]
                       <= np.arange(tq)[:, None] + (tk - tq))[None]
    return keep.any(-1)


FLASH_CASES = {
    "causal_masked": dict(causal=True, tq=64, tk=64),
    "bidirectional_masked": dict(causal=False, tq=64, tk=64),
    "causal_tq_lt_tk": dict(causal=True, tq=40, tk=72),
    "ragged_t": dict(causal=True, tq=80, tk=80),
    "prompt_lengths_with_empty_row": dict(causal=True, tq=48, tk=48,
                                          lengths=[48, 0, 17]),
    "unmasked": dict(causal=False, tq=40, tk=40, unmasked=True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_flash_kernel(case):
    c = dict(FLASH_CASES[case])
    causal, unmasked = c.pop("causal"), c.pop("unmasked", False)
    lengths = c.pop("lengths", None)
    b = 3 if lengths is not None else 2
    q, k, v, km = _qkv(5, b=b, lengths=lengths, **c)
    km = None if unmasked else km
    ro, rl, rm = _jax_flash(q, k, v, km, causal)
    o, l, m = att.flash_attention_plain(
        *_t(q, k, v), None if km is None else torch.tensor(km), causal)
    assert torch.isfinite(o).all() and torch.isfinite(l).all()
    rows = _valid_rows(km, q.shape[2], k.shape[2], causal, q.shape[0])
    np.testing.assert_allclose(o.numpy()[rows.nonzero()[0], :,
                                         rows.nonzero()[1]],
                               ro[rows.nonzero()[0], :, rows.nonzero()[1]],
                               **F32)
    np.testing.assert_allclose(l.numpy().transpose(0, 2, 1)[rows],
                               rl.transpose(0, 2, 1)[rows], **F32)
    np.testing.assert_allclose(m.numpy().transpose(0, 2, 1)[rows],
                               rm.transpose(0, 2, 1)[rows], **F32)


def test_flash_plain_matches_jax_flash_kernel_bf16():
    q, k, v, km = _qkv(6, tq=64, tk=64)
    ro, rl, rm = _jax_flash(q, k, v, km, True, jnp.bfloat16)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    o, l, m = att.flash_attention_plain(*bf, torch.tensor(km), True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), ro, **BF16)
    np.testing.assert_allclose(l.numpy(), rl, **BF16)
    np.testing.assert_allclose(m.numpy(), rm, **BF16)


@pytest.mark.parametrize("s,page", [(32, 8), (16, 64)])
def test_paged_decode_plain_matches_jax_paged_kernel(s, page):
    q, kc, vc = _caches(7, s=s)
    pos = np.minimum(POSITIONS, s + 8)
    ref = np.asarray(jatt.paged_decode_attention(
        *_j(q, kc, vc, pos), page=page, interpret=True))
    got = att.paged_decode_attention_plain(*_t(q, kc, vc),
                                           torch.tensor(pos), page=page)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_paged_decode_plain_matches_jax_paged_kernel_bf16():
    q, kc, vc = _caches(8)
    ref = np.asarray(jatt.paged_decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)),
        jnp.asarray(POSITIONS), page=8, interpret=True).astype(jnp.float32))
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, kc, vc)]
    got = att.paged_decode_attention_plain(*bf, torch.tensor(POSITIONS),
                                           page=8)
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    q, k, v, km = _qkv(9)
    before = att.flash_attention.launches
    o, l, m = att.flash_attention(*_t(q, k, v), torch.tensor(km), True,
                                  return_stats=True)
    ro, rl, rm = att.flash_attention_plain(*_t(q, k, v), torch.tensor(km),
                                           True)
    assert torch.equal(o, ro) and torch.equal(l, rl) and torch.equal(m, rm)
    assert torch.equal(att.flash_attention(*_t(q, k, v), torch.tensor(km),
                                           True), ro)
    assert att.flash_attention.launches == before
    qd, kc, vc = _caches(10)
    before = att.paged_decode_attention.launches
    got = att.paged_decode_attention(*_t(qd, kc, vc),
                                     torch.tensor(POSITIONS), page=8)
    ref = att.paged_decode_attention_plain(*_t(qd, kc, vc),
                                           torch.tensor(POSITIONS), page=8)
    assert torch.equal(got, ref)
    assert att.paged_decode_attention.launches == before


def test_plain_versions_agree_with_the_oracles():
    q, k, v, km = _qkv(11, tq=24, tk=56)
    tq, tk = q.shape[2], k.shape[2]
    o, _, _ = att.flash_attention_plain(*_t(q, k, v), torch.tensor(km), True)
    ref = att.reference_attention(*_t(q, k, v), torch.tensor(km), True)
    rows = _valid_rows(km, tq, tk, True)
    bi, ti = rows.nonzero()
    np.testing.assert_allclose(o.numpy()[bi, :, ti], ref.numpy()[bi, :, ti],
                               **F32)
    qd, kc, vc = _caches(12)
    pos = torch.tensor(POSITIONS)
    np.testing.assert_allclose(
        att.paged_decode_attention_plain(*_t(qd, kc, vc), pos).numpy(),
        att.decode_attention(*_t(qd, kc, vc), pos).numpy(), **F32)
    # a negative position has no live page: the kernel writes zeros
    neg = att.paged_decode_attention_plain(*_t(qd, kc, vc),
                                           torch.tensor([-1, 0, 0, 0, 0]))
    assert torch.equal(neg[0], torch.zeros_like(neg[0]))


FLASH_REFUSALS = ["dtype", "mixed_dtype", "head_dim", "shape", "mask_shape",
                  "device"]


@pytest.mark.parametrize("case", FLASH_REFUSALS)
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = (torch.zeros(1, 2, 8, 16) for _ in range(3))
    km = None
    if case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 192) for _ in range(3))
    elif case == "shape":
        v = torch.zeros(1, 2, 9, 16)
    elif case == "mask_shape":
        km = torch.ones(1, 9)
    elif case == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        att.flash_attention(q, k, v, km, True)


DECODE_REFUSALS = ["dtype", "head_dim", "page_divides", "page_too_big",
                   "positions_dtype", "shape"]


@pytest.mark.parametrize("case", DECODE_REFUSALS)
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, kc, vc = torch.zeros(2, 2, 16), torch.zeros(2, 48, 2, 16), \
        torch.zeros(2, 48, 2, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    page = 16
    if case == "dtype":
        q, kc, vc = q.half(), kc.half(), vc.half()
    elif case == "head_dim":
        q, kc, vc = torch.zeros(2, 2, 200), torch.zeros(2, 48, 2, 200), \
            torch.zeros(2, 48, 2, 200)
    elif case == "page_divides":
        page = 32
    elif case == "page_too_big":
        q, kc, vc = torch.zeros(2, 2, 16), torch.zeros(2, 256, 2, 16), \
            torch.zeros(2, 256, 2, 16)
        page = 128
    elif case == "positions_dtype":
        pos = pos.float()
    elif case == "shape":
        q = torch.zeros(2, 3, 16)
    with pytest.raises(ValueError):
        att.paged_decode_attention(q, kc, vc, pos, page=page)


def test_head_dim_qualifier():
    assert all(att.head_dim_supported(d) for d in (1, 16, 48, 64, 128, 256,
                                                   384, 512))
    assert not any(att.head_dim_supported(d) for d in (0, 129, 192, 640))


def test_dispatcher_tiers():
    q, k, v, km = _qkv(13, tq=16, tk=16)
    tq, tk = _t(q, k, v), torch.tensor(km)
    ref = att.reference_attention(*tq, tk, True)
    assert torch.equal(att.dot_product_attention(*tq, tk, True), ref)
    blk = att.dot_product_attention(*tq, tk, True, impl="blockwise")
    np.testing.assert_allclose(blk.numpy(), ref.numpy(), **F32)
    fl = att.dot_product_attention(*tq, tk, True, impl="flash")
    np.testing.assert_allclose(fl.numpy(), ref.numpy(), **F32)


def test_routes_take_the_kernels_only_where_they_qualify():
    from deeplearning4j_tpu_torch.kernels import routing

    q, k, v, km = _qkv(14, tq=16, tk=16)
    tq, tkm = _t(q, k, v), torch.tensor(km)
    o = routing.maybe_flash_attention(*tq, key_mask=tkm, causal=True)
    assert torch.equal(o, att.flash_attention(*tq, tkm, True))
    wide = [torch.zeros(1, 1, 4, 192) for _ in range(3)]
    assert routing.maybe_flash_attention(*wide) is None  # head size
    half = [t.half() for t in tq]
    assert routing.maybe_flash_attention(*half) is None  # dtype
    qd, kc, vc = _caches(15, s=32)
    pos = torch.tensor(POSITIONS)
    got = routing.maybe_decode_attention(*_t(qd, kc, vc), pos)
    assert torch.equal(got, att.paged_decode_attention(*_t(qd, kc, vc), pos))
    qd, kc, vc = _caches(16, s=96)  # 64-slot pages do not divide 96
    assert routing.maybe_decode_attention(*_t(qd, kc, vc), pos) is None
