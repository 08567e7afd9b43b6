"""The 3xTF32 split of ``csrc/mma_tiles.cuh::split_tf32`` mirrored in numpy:
the three products of ``mma_3xtf32`` keep the float32 product's NaN and
infinity, and a finite x near FLT_MAX stays finite.

The CUDA kernels cannot run here. This mirror holds the integer recipe the
header writes, so that a change to one is a change to the other; the card
holds the kernels themselves against their plain versions on the same
special values (chip_session.py, [34a])."""

import numpy as np
import pytest

import torch_threads  # noqa: F401

TOP = 0x7F7FF000
INF = 0x7F800000


def to_tf32(u):
    return (u + 0x1000) & 0xFFFFE000


def split(x):
    """``split_tf32`` of a float32 array: (big, small) as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    a = u & 0x7FFFFFFF
    big = np.where(a < TOP, to_tf32(u) & 0xFFFFFFFF, u & 0xFFFFE000)
    big = np.where(a == INF, (u & 0x80000000) | 0x3F800000, big)
    big = np.where(a > INF, (u & 0xFFFFE000) | 0x00400000, big)
    big32 = big.astype(np.uint32).view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        rest = (np.asarray(x, np.float32) - big32).view(np.uint32)
    small = np.where(a < TOP, to_tf32(rest.astype(np.uint64)) & 0xFFFFFFFF,
                     rest.astype(np.uint64) & 0xFFFFE000)
    small = np.where(a == INF, u, small)
    small = np.where(a > INF, big, small)
    return big32, small.astype(np.uint32).view(np.float32)


def product_3x(x, y):
    """x * y as ``mma_3xtf32`` forms it: small . big, big . small, big .
    big, summed in float32 in that order."""
    xb, xs = split(x)
    yb, ys = split(y)
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.float32(0) + xs * yb
        d = d + xb * ys
        return d + xb * yb


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


SPECIAL = _bits(0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0x7F800001, 0xFF800000,
                0x7F800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000)


@pytest.mark.parametrize("i", range(len(SPECIAL)))
def test_split_keeps_nan_inf_and_near_max(i):
    x = SPECIAL[i:i + 1]
    big, small = split(x)
    with np.errstate(invalid="ignore", over="ignore"):
        total = big.astype(np.float64) + small.astype(np.float64)
    if np.isnan(x[0]):
        assert np.isnan(big[0]) and np.isnan(total[0])
        assert (big.view(np.uint32)[0] & 0x1FFF) == 0  # inside TF32's bits
    elif np.isinf(x[0]):
        assert big[0] == np.copysign(1.0, x[0]) and small[0] == x[0]
    else:
        assert np.isfinite(big[0]) and np.isfinite(small[0])
        assert (big.view(np.uint32)[0] & 0x1FFF) == 0
        assert abs(total[0] - np.float64(x[0])) <= abs(np.float64(x[0])) * 2.0 ** -21


def test_products_keep_the_float32_pattern():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(4096).astype(np.float32)
    y[:4] = [0.0, -0.0, 1.0, -2.0]  # partners whose small part is 0
    y[4:8] = SPECIAL[3:5].repeat(2)  # inf meets inf
    for x in SPECIAL:
        xs = np.full_like(y, x)
        with np.errstate(invalid="ignore", over="ignore"):
            ref = xs * y
        got = product_3x(xs, y)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=2.0 ** -20)


def test_the_old_rounding_lost_them():
    """The two-operation rounding the header used for every x: a NaN CUDA
    arithmetic makes came out -0.0, and a near-FLT_MAX x infinity."""
    u = _bits(0x7FFFFFFF, 0xFFFFFFFF, 0x7F7FFFFF).view(np.uint32)
    old = (to_tf32(u.astype(np.uint64)) & 0xFFFFFFFF).astype(np.uint32)
    assert old.view(np.float32)[0] == 0 and np.signbit(old.view(np.float32)[0])
    assert old.view(np.float32)[1] == 0
    assert np.isinf(old.view(np.float32)[2])


def test_finite_values_split_as_before():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(10000) * 10.0 ** rng.integers(-30, 30, 10000)
         ).astype(np.float32)
    big, small = split(x)
    u = x.view(np.uint32).astype(np.uint64)
    old_big = (to_tf32(u) & 0xFFFFFFFF).astype(np.uint32)
    np.testing.assert_array_equal(big.view(np.uint32), old_big)
    np.testing.assert_allclose(big.astype(np.float64) + small, x,
                               rtol=2.0 ** -21)
