"""The arithmetic of the tensor-core ``matmul_stats`` and of the split-KV
cluster decode kernel, on the CPU.

``matmul_stats`` (``csrc/matmul_stats.cu`` on ``csrc/tc_gemm.cuh``) forms
y = x . w^T with TF32 tensor-core MMAs through the 3xTF32 split (three MMAs
of 8-deep k chunks a product), and the tensor cores round each accumulation
toward zero. Here every MMA is emulated as an exact sum of its 8 products
and its accumulator input, rounded toward zero to float32 once. Summed
straight, every output lives in one accumulator for all of K; summed fresh
(the kernel's ``kFresh``), each 32-deep K step starts from zero and is added
to the accumulator with an ordinary round-to-nearest f32 add. The column
statistics of the rounded y are then held to ``chip_smoke.py``'s
``STATS_RTOL["float32"]`` against ``matmul_stats_plain``, at ResNet-50's 15
1x1 shapes with M cut 64-fold (the relative bias of sum(y^2), the quantity
the straight sum gets wrong, does not depend on M).

``paged_decode_attention`` (``csrc/paged_decode_attention.cu``) splits the
live pages of each (row, head) over a cluster of 8 blocks: the pages are cut
into chunks of at most 1024 / DP slots, rank r takes the row's live chunks
r, r + 8, ... with an online softmax, and rank 0 combines the ranks'
(m, l, o) in rank order.
``emulated_cluster_decode`` does the same in torch, and is held to the JAX
package's Pallas kernel (interpret mode) and to
``paged_decode_attention_plain`` at ``DECODE_TOL``; a row's output is the
same bits whatever batch it is decoded in.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jatt
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
_TC = _load("_tc_split", ROOT / "test_torch_tc_split.py")
tf32 = _BWD.tf32
STATS_RTOL = _CS.STATS_RTOL["float32"]
DECODE_TOL = _CS.DECODE_TOL

# ---------------------------------------------------------------------------
# matmul_stats through the 3xTF32 split, round-toward-zero accumulation
# ---------------------------------------------------------------------------

BK = 32  # tc_gemm.cuh's K step
# matmul_stats.cu's kStraightMaxK: float32 sums K steps fresh above it
STRAIGHT_MAX_K = int(re.search(
    r"constexpr int kStraightMaxK = (\d+);",
    (ROOT.parent / "deeplearning4j_tpu_torch" / "csrc" / "matmul_stats.cu")
    .read_text()).group(1))
STATS_CASES = _TC.GEMM_CASES  # ResNet-50's 15 1x1 shapes, M / 64


def straight_misses(k: int, n: int) -> bool:
    """Where the emulated straight sum puts sum(y^2) outside STATS_RTOL:
    every shape at K >= 1024 (1.9e-5 to 4.6e-5 of sum(y^2)) and K = 512 at
    N = 2048 (1.2e-5); the other K = 512 shapes sit at the tolerance (0.93
    to 1.001 of it), and K <= 256 within 0.6 of it (0.13 to 0.51)."""
    return k >= 1024 or (k == 512 and n == 2048)


def rz(x64: torch.Tensor) -> torch.Tensor:
    """float64 rounded toward zero to float32."""
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def emulated_stats_gemm(x, w, fresh: bool):
    """``x @ w.T`` as ``tc_gemm.cuh`` forms it in float32: per 8-deep k
    chunk three MMAs (small . big, big . small, big . big), each an exact
    sum rounded toward zero into its accumulator; ``fresh``: each BK step
    summed from zero, then added to the accumulator (round to nearest)."""
    xb, wb = tf32(x), tf32(w)
    xs, ws = tf32(x - xb), tf32(w - wb)
    pairs = [(a.double(), b.double()) for a, b in ((xs, wb), (xb, ws),
                                                   (xb, wb))]
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], BK):
        d = torch.zeros_like(acc) if fresh else acc
        for kk in range(k0, min(k0 + BK, x.shape[1]), 8):
            for a, b in pairs:
                d = rz(d.double() + a[:, kk:kk + 8] @ b[:, kk:kk + 8].T)
        acc = acc + d if fresh else d
    return acc


def _stats_errors(case, fresh):
    """Per column, the largest |s - s_ref| / sum|y| and |q - q_ref| /
    sum(y^2) of the emulated kernel against ``matmul_stats_plain``, as
    ``chip_smoke.py`` [6] measures them."""
    x, w, _ = _TC._gemm(case)
    y = emulated_stats_gemm(x, w, fresh)
    s, q = y.sum(0), (y * y).sum(0)
    _, rs, rq = impls.matmul_stats_plain(x, w)
    y64 = y.double()
    err_s = ((s.double() - rs.double()).abs() / y64.abs().sum(0)).max()
    err_q = ((q.double() - rq.double()).abs() / (y64 * y64).sum(0)).max()
    return float(err_s), float(err_q)


@pytest.mark.parametrize("case", STATS_CASES, ids=str)
def test_fresh_k_steps_hold_stats_rtol(case):
    err_s, err_q = _stats_errors(case, fresh=True)
    assert err_s <= STATS_RTOL and err_q <= STATS_RTOL, (err_s, err_q)


@pytest.mark.parametrize("case", STATS_CASES, ids=str)
def test_the_kernels_choice_holds_stats_rtol_with_room(case):
    """``matmul_stats.cu`` sums float32 K steps fresh where K > 256 and
    straight at K <= 256: within 0.6 of STATS_RTOL at every shape."""
    err_s, err_q = _stats_errors(case, fresh=case[1] > STRAIGHT_MAX_K)
    assert max(err_s, err_q) < 0.6 * STATS_RTOL, (err_s, err_q)


@pytest.mark.parametrize("case", STATS_CASES, ids=str)
def test_straight_accumulation_misses_stats_rtol_at_large_k(case):
    """Straight accumulation biases every |y| low by its partial sums'
    roundings toward zero, about 3 K / 8 of them, and sum(y^2) by twice as
    much: outside STATS_RTOL where ``straight_misses`` says so, at its edge
    at the other K = 512 shapes, within it at K <= 256."""
    _, k, n = case
    err_s, err_q = _stats_errors(case, fresh=False)
    if straight_misses(k, n):
        assert err_q > STATS_RTOL, (err_s, err_q)
    elif k == 512:
        assert 0.8 * STATS_RTOL < err_q < 1.05 * STATS_RTOL, (err_s, err_q)
    else:
        assert err_s <= STATS_RTOL and err_q < 0.6 * STATS_RTOL, (err_s, err_q)


def test_round_toward_zero_emulation_rounds_toward_zero():
    v = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0,
                      1.0 - 2.0 ** -40], dtype=torch.float64)
    got = rz(v)
    assert got.tolist() == [1.0, -1.0, 3.0,
                            float(np.nextafter(np.float32(1), np.float32(0)))]


# ---------------------------------------------------------------------------
# the split-KV cluster decode kernel
# ---------------------------------------------------------------------------

RANKS = 8


def _decode_constant(name: str) -> int:
    """An integer constant of ``csrc/paged_decode_attention.cu``."""
    src = (ROOT.parent / "deeplearning4j_tpu_torch" / "csrc"
           / "paged_decode_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


STAGE_ELEMS = _decode_constant("kStageElems")  # elements of K a stage
WARPS = _decode_constant("kThreads") // 32


def padded_head_dim(d: int) -> int:
    """The kernel's DP variant of head size d."""
    return next(p for p in (32, 64, 128, 256, 512) if d <= p)


def chunk_slots(page: int, d: int):
    """(chunks a page, slots a chunk): chunks of at most STAGE_ELEMS / DP
    slots (at least one a warp, at most 64), as even as the page allows."""
    cap = min(64, max(WARPS, STAGE_ELEMS // padded_head_dim(d)))
    cpp = -(-page // cap)
    return cpp, -(-page // cpp)


def rank_chunks(pos: int, s: int, page: int, d: int, rank: int):
    """The slot ranges [s0, s1) cluster rank ``rank`` takes for a row at
    ``pos``: the row's live chunks rank, rank + 8, ... (every chunk of every
    page at or below the position; the boundary page whole)."""
    npages = 0 if pos < 0 else min(pos, s - 1) // page + 1
    cpp, chunk = chunk_slots(page, d)
    out = []
    for gc in range(rank, npages * cpp, RANKS):
        pg, c = divmod(gc, cpp)
        s0 = pg * page + c * chunk
        out.append((s0, min(s0 + chunk, (pg + 1) * page)))
    return out


def emulated_cluster_decode(q, k_cache, v_cache, positions, scale=None,
                            page=64):
    """The cluster kernel's function and order of work, all rows and heads
    at once: each rank's chunks with an online softmax (f32 scores times
    the scale, slots past the position set to NEG_INF, p unrounded), then
    rank 0's combine in rank order; o rounded once to q's dtype."""
    b, s, h, d = k_cache.shape
    page = min(page, s)
    sm = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf = q.float(), k_cache.float(), v_cache.float()
    pos = [int(p) for p in positions]
    parts = []
    for rank in range(RANKS):
        m = torch.full((b, h), att.NEG_INF)
        l = torch.zeros((b, h))
        o = torch.zeros((b, h, d))
        chunks = [rank_chunks(p, s, page, d, rank) for p in pos]
        for i in range(max(map(len, chunks))):
            for row, mine in enumerate(chunks):
                if i >= len(mine):
                    continue  # the row's rank has no more chunks
                s0, s1 = mine[i]
                kt, vt = kf[row, s0:s1], vf[row, s0:s1]  # [n, h, d]
                sc = (qf[row][None] * kt).sum(-1).T * sm  # [h, n]
                live = torch.arange(s0, s1) <= pos[row]
                sc = sc.masked_fill(~live[None], att.NEG_INF)
                m_new = torch.maximum(m[row], sc.amax(-1))
                p = torch.exp(sc - m_new[:, None])
                alpha = torch.exp(m[row] - m_new)
                l[row] = l[row] * alpha + p.sum(-1)
                o[row] = o[row] * alpha[:, None] + (p.T[:, :, None]
                                                    * vt).sum(0)
                m[row] = m_new
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    weights = [torch.exp(m - mx) for m, _, _ in parts]
    total_l = sum(l * wt for (_, l, _), wt in zip(parts, weights))
    total_o = sum(o * wt[..., None] for (_, _, o), wt in zip(parts, weights))
    linv = torch.where(total_l == 0, torch.ones_like(total_l), 1.0 / total_l)
    return (total_o * linv[..., None]).to(q.dtype)


def _decode_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, kc, vc


def _decode_positions(s):
    """-1, 0, 63, 64, S - 1, S, and two between."""
    return np.asarray([-1, 0, 63, 64, s - 1, s, s // 2, 3 * s // 4],
                      np.int32)


def _outside(got, want, tol):
    atol, rtol = tol
    return int(((got.double() - want.double()).abs()
                > atol + rtol * want.double().abs()).sum())


# (cache length S, page, head size); each case has 8 rows at the positions
# of _decode_positions and 2 heads
DECODE_CASES = [(1024, 64, 64), (512, 64, 128), (256, 16, 32),
                (640, 64, 256), (128, 32, 48), (192, 48, 512)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_cluster_decode_emulation_matches_jax_paged_kernel(case):
    s, page, d = case
    q, kc, vc = _decode_inputs(sum(case), 8, s, 2, d)
    pos = _decode_positions(s)
    ref = np.asarray(jatt.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        page=page, interpret=True))
    got = emulated_cluster_decode(*map(torch.tensor, (q, kc, vc)),
                                  torch.tensor(pos), page=page)
    assert _outside(got, torch.tensor(ref), DECODE_TOL["float32"]) == 0
    assert bool((got[0] == 0).all())  # position -1: zeros


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_decode_emulation_matches_the_plain_version(case, dtype):
    s, page, d = case
    tdt = getattr(torch, dtype)
    q, kc, vc = (torch.tensor(a).to(tdt)
                 for a in _decode_inputs(sum(case) + 1, 8, s, 2, d))
    pos = torch.tensor(_decode_positions(s))
    got = emulated_cluster_decode(q, kc, vc, pos, page=page)
    ref = att.paged_decode_attention_plain(q, kc, vc, pos, page=page)
    assert got.dtype == tdt
    assert _outside(got, ref, DECODE_TOL[dtype]) == 0


def test_a_row_with_one_live_chunk_leaves_ranks_1_to_7_empty():
    s, page, d = 256, 16, 64  # a 16-slot page is one chunk at D = 64
    for p in (0, 5, 15):
        assert rank_chunks(p, s, page, d, 0) == [(0, 16)]
        assert all(rank_chunks(p, s, page, d, r) == []
                   for r in range(1, RANKS))
    assert rank_chunks(16, s, page, d, 1) == [(16, 32)]
    assert rank_chunks(-1, s, page, d, 0) == []
    q, kc, vc = (torch.tensor(a) for a in _decode_inputs(3, 1, s, 2, d))
    pos = torch.tensor([9], dtype=torch.int32)
    got = emulated_cluster_decode(q, kc, vc, pos, page=page)
    ref = att.paged_decode_attention_plain(q, kc, vc, pos, page=page)
    assert _outside(got, ref, DECODE_TOL["float32"]) == 0


@pytest.mark.parametrize("d", [32, 64, 128, 512])
def test_rank_split_covers_every_live_slot_once(d):
    s, page = 1024, 64
    for p in (-1, 0, 63, 64, 500, 1023, 1024, 5000):
        taken = sorted(slot for r in range(RANKS)
                       for s0, s1 in rank_chunks(p, s, page, d, r)
                       for slot in range(s0, s1))
        live = 0 if p < 0 else min(p, s - 1) // page + 1
        assert taken == list(range(live * page))  # whole pages, once each


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_row_decodes_to_the_same_bits_at_batch_1_and_8(dtype):
    s, page, d = 1024, 64, 64
    tdt = getattr(torch, dtype)
    q, kc, vc = (torch.tensor(a).to(tdt)
                 for a in _decode_inputs(11, 8, s, 2, d))
    pos = torch.tensor(_decode_positions(s))
    batch = emulated_cluster_decode(q, kc, vc, pos, page=page)
    for row in range(8):
        alone = emulated_cluster_decode(q[row:row + 1], kc[row:row + 1],
                                        vc[row:row + 1], pos[row:row + 1],
                                        page=page)
        assert torch.equal(alone[0], batch[row]), row


@pytest.mark.parametrize("page,d,want", [(64, 64, (4, 16)), (64, 32, (2, 32)),
                                         (64, 128, (8, 8)), (64, 256, (16, 4)),
                                         (64, 512, (16, 4)), (48, 128, (6, 8)),
                                         (37, 128, (5, 8)), (16, 512, (4, 4))])
def test_chunks_split_a_page_evenly_within_a_stage(page, d, want):
    assert (STAGE_ELEMS, WARPS) == (1024, 4)  # the table below assumes them
    cpp, chunk = chunk_slots(page, d)
    assert (cpp, chunk) == want
    dp = padded_head_dim(d)
    assert chunk * dp <= max(STAGE_ELEMS, WARPS * dp) and cpp * chunk >= page
