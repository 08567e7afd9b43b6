"""The data movement of the tensor-core ``matmul_bias_act_int8``, on the CPU.

``csrc/matmul_bias_act_int8.cu`` forms y^T on ``mma.sync`` m16n8k32 s8: the
weights are the A operand (MMA rows = output columns), the batch the B
operand. A lane reads 8 bytes of each of four k rows of the staged wq slice
(each group of 4 rows offset 32 bytes in shared memory), turns them into the
k-words of its 8 columns with two 4 x 4 byte transposes (``__byte_perm``);
at M <= 32 four warps take alternate k32 steps of a slice; K is split in
32-row units over the ranks of a thread-block cluster whose int32 partials
are added through distributed shared memory before the epilogue.

``emulate`` repeats that in numpy: the staging in the kernel's row layout,
the lanes' loads and the transposes (the ``__byte_perm`` program read from
the source), PTX's m16n8k32 fragment map (each register decoded to its
(row, k) or (k, column) and the products formed from the decoded matrices),
each warp group's k32 steps, the kernel's store of each group's accumulators
to its partial tile and the groups' sum, the K partition over ranks and
their sum (the owner of each 4-column group adds the ranks' sums), and the
epilogue. The kernel's constants and tile
configs are read from the source. A model of the ring's mbarriers checks
the handover between the producer warps and the MMA warps under random
interleavings. The emulation is held bit for bit to
``matmul_bias_act_int8_plain`` and to the JAX package's Pallas kernel in
interpret mode (identity, scale 1, bias 0: the sums themselves), and its
epilogue to the plain version's (both round the product, then the bias).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.kernels import impls as jimpls
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import impls

pytestmark = pytest.mark.torch

SOURCE = (Path(__file__).resolve().parent.parent / "deeplearning4j_tpu_torch"
          / "csrc" / "matmul_bias_act_int8.cu").read_text()
SMS = 132  # an H100 SXM's SMs


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARP_STEPS = _const("kWarpSteps")
WARP_COLS = _const("kWarpCols")
X_PAD = _const("kXPad")
STAGES = _const("kStages")
UNIT = _const("kUnit")
MAX_RANKS = _const("kMaxRanks")
MIN_ROWS = _const("kMinRows")
BLOCKS_PER_SM = _const("kBlocksPerSm")
TILES = [tuple(int(v) for v in cfg) for cfg in re.findall(
    r"\{(\d+), (\d+), (\d+), (\d+)\}",
    re.search(r"constexpr int kTiles\[\d+\]\[4\] = \{(.*?)\};",
              SOURCE, re.S).group(1))]
# the transpose: (destination, x, y, selector) of each __byte_perm in order
_TRANSPOSE = re.findall(
    r"([\w\[\]]+) = __byte_perm\(([\w\[\]]+), ([\w\[\]]+), (0x[0-9a-fA-F]+)\)",
    re.search(r"void transpose4x4\(.*?\{(.*?)\n\}", SOURCE, re.S).group(1))
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` (PTX ``prmt`` default mode): byte i
    of the result is byte (nibble i of s) & 7 of the 8 bytes {y, x}, x the
    low four; nibble bit 3 replicates that byte's sign bit."""
    both = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    out = np.zeros(both.shape, np.uint64)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        byte = (both >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF),
                            np.uint64(0))
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose4x4(r):
    """The source's ``transpose4x4`` run with ``byte_perm``: four words (row
    j's bytes of four columns) to four words (column i's bytes of four
    rows)."""
    env = {f"r[{j}]": np.asarray(r[j], np.uint32) for j in range(4)}
    for dst, a, b, sel in _TRANSPOSE:
        env[dst] = byte_perm(env[a], env[b], int(sel, 16))
    return [env[f"c[{i}]"] for i in range(4)]


def tile(cfg: int):
    """(WN, WM, NT, BM, BN) of a tile config."""
    wn, wm, nt, _ = TILES[cfg]
    return wn, wm, nt, 8 * nt * wm, WARP_COLS * wn


def k_groups(cfg: int) -> int:
    """Warps along K: they take alternate k32 steps of a slice."""
    return TILES[cfg][3]


def slice_k(cfg: int) -> int:
    """The k of a staged slice: kWarpSteps k32 steps for each warp along K."""
    return 32 * k_groups(cfg) * WARP_STEPS


def plan(m: int, n: int, k: int, num_sms: int = SMS):
    """(tile config, cluster ranks) as ``dl4j_matmul_int8_plan`` picks
    them: the config by M (and N past M = 32), the ranks doubled up to
    kMaxRanks while the grid stays within kBlocksPerSm blocks an SM and
    every rank keeps kMinRows rows of K."""
    cfg = (0 if m <= 8 else 1 if m <= 16 else 2 if m <= 32
           else 3 if n > WARP_COLS else 4)
    _, _, _, bm, bn = tile(cfg)
    tiles = -(-m // bm) * -(-n // bn)
    units = -(-k // UNIT)
    ranks = 1
    while (ranks < MAX_RANKS and tiles * 2 * ranks <= BLOCKS_PER_SM * num_sms
           and units >= 2 * ranks * (MIN_ROWS // UNIT)):
        ranks *= 2
    return cfg, ranks


def rank_rows(rank: int, ranks: int, k: int):
    """The K rows [kb, ke) of cluster rank ``rank``: whole kUnit-row units,
    split as evenly as they go."""
    units = -(-k // UNIT)
    return (UNIT * (rank * units // ranks),
            min(k, UNIT * ((rank + 1) * units // ranks)))


def w_row(bn: int, r):
    """Where row ``r`` of a staged wq slice starts: each group of 4 rows 32
    bytes past the last (``w_row`` of the source)."""
    r = np.asarray(r)
    return r * bn + 32 * (r >> 2)


def _words(b):
    """Little-endian 32-bit words of the last axis (4 bytes)."""
    u = np.asarray(b).view(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def _bytes(words):
    """The 4 signed bytes of each word, on a new last axis."""
    w = np.asarray(words, np.uint32)[..., None] >> (8 * np.arange(4,
                                                                  dtype=np.uint32))
    return (w & 0xFF).astype(np.uint8).view(np.int8)


# PTX's m16n8k32 .s8 fragments, lane (g, t): A register p, byte j holds
# (row g + 8 (p % 2), k 4t + j + 16 (p // 2)); B register e, byte j holds
# (k 4t + j + 16 e, column g); accumulator d holds (row g + 8 (d // 2),
# column 2t + d % 2).
_P, _J = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
A_ROW = G[:, None, None] + 8 * (_P % 2)[None]
A_K = 4 * T[:, None, None] + _J[None] + 16 * (_P // 2)[None]
_E, _JB = np.meshgrid(np.arange(2), np.arange(4), indexing="ij")
B_K = 4 * T[:, None, None] + _JB[None] + 16 * _E[None]
B_COL = np.broadcast_to(G[:, None, None], B_K.shape)
D_ROW = G[:, None] + 8 * (np.arange(4) // 2)[None]
D_COL = 2 * T[:, None] + (np.arange(4) % 2)[None]


def a_fragments(wr, cfg: int):
    """The A registers [S, column tiles, k32 steps, WN, lane, tile i, 4] of
    wq rows ``wr`` [S slices x slice_k, column tiles x BN]: each slice staged
    in the kernel's row layout, 8 bytes a row read by each lane at
    (kk + 16h + 4t + j, 64 wn + 8g), transposed."""
    wn_, _, _, _, bn = tile(cfg)
    bk = slice_k(cfg)
    s = wr.shape[0] // bk
    tn = wr.shape[1] // bn
    logical = wr.reshape(s, bk, tn, bn).transpose(0, 2, 1, 3)
    phys = np.zeros((s, tn, int(w_row(bn, bk))), np.int8)
    rr = np.arange(bk)[:, None]
    phys[:, :, w_row(bn, rr) + np.arange(bn)[None, :]] = logical
    kk = np.arange(bk // 32)
    rows = (32 * kk[:, None, None, None] + 16 * np.arange(2)[None, :, None, None]
            + np.arange(4)[None, None, :, None] + 4 * T)   # [kk, h, j, lane]
    cols = WARP_COLS * np.arange(wn_)[:, None] + 8 * G      # [WN, lane]
    off = w_row(bn, rows[:, :, :, None, :]) + cols[None, None, None]
    raw = np.stack([phys[:, :, off + j] for j in range(8)], -1)
    lo, hi = _words(raw[..., :4]), _words(raw[..., 4:])  # [S,tn,kk,h,j,WN,lane]
    a = np.zeros(lo.shape[:3] + (wn_, 32, 4, 4), np.uint32)
    for h in range(2):
        cl = transpose4x4([lo[:, :, :, h, j] for j in range(4)])
        ch = transpose4x4([hi[:, :, :, h, j] for j in range(4)])
        for i in range(4):
            a[..., i, 2 * h] = cl[i]      # row g of tile i: column 8g + i
            a[..., i, 2 * h + 1] = ch[i]  # row g + 8: column 8g + 4 + i
    return a


def b_fragments(xr, cfg: int):
    """The B registers [S, row tiles, k32 steps, WM, NT, lane, 2] of xq
    columns ``xr`` [row tiles x BM, S slices x slice_k]: rows staged kXPad
    bytes apart, lane (g, t) of n8 tile q reading row 8 (NT wm + q) + g at
    k kk + 4t and kk + 16 + 4t."""
    _, wm_, nt, bm, _ = tile(cfg)
    bk = slice_k(cfg)
    s = xr.shape[1] // bk
    tm = xr.shape[0] // bm
    xs = np.zeros((s, tm, bm, bk + X_PAD), np.int8)
    xs[..., :bk] = xr.reshape(tm, bm, s, bk).transpose(2, 0, 1, 3)
    rows = (8 * (nt * np.arange(wm_)[:, None, None] + np.arange(nt)[None, :, None])
            + G)                                            # [WM, NT, lane]
    kk = np.arange(bk // 32)
    cols = (32 * kk[:, None, None, None] + 4 * T[None, :, None, None]
            + 16 * np.arange(2)[None, None, :, None]
            + np.arange(4)[None, None, None, :])            # [kk, lane, e, j]
    raw = xs[:, :, rows[None, :, :, :, None, None], cols[:, None, None]]
    return _words(raw)


def mma(a, b, steps=None):
    """Sum over slices and the k32 steps ``steps`` (all by default) of the
    warps' m16n8k32 products, as lanes' accumulators [row tiles, column
    tiles, WN, WM, tile i, NT, lane, 4]: each register decoded by PTX's
    map, the products exact."""
    if steps is not None:
        a, b = a[:, :, steps], b[:, :, steps]
    s, tn, nkk, wn_ = a.shape[:4]
    _, tm, _, wm_, nt = b.shape[:5]
    am = np.zeros((s, tn, nkk, wn_, 4, 16, 32), np.int8)
    am[..., A_ROW, A_K] = _bytes(a).transpose(0, 1, 2, 3, 5, 4, 6, 7)
    bmat = np.zeros((s, tm, nkk, wm_, nt, 32, 8), np.int8)
    bmat[..., B_K, B_COL] = _bytes(b)
    # exact in float64: |sum| < 2**31 < 2**53
    lhs = am.transpose(1, 3, 4, 5, 0, 2, 6).reshape(tn * wn_ * 4 * 16, -1)
    rhs = bmat.transpose(0, 2, 5, 1, 3, 4, 6).reshape(s * nkk * 32, -1)
    d = np.rint(lhs.astype(np.float64) @ rhs.astype(np.float64)).astype(np.int64)
    d = d.reshape(tn, wn_, 4, 16, tm, wm_, nt, 8).transpose(4, 0, 1, 5, 2, 6, 3, 7)
    return d[..., D_ROW, D_COL]


def store_partial(acc, cfg: int):
    """The kernel's store of the accumulators to the partial tile [row
    tiles, column tiles, BM, BN]: lane (g, t) register 2hh + e of tile i,
    n8 tile q to row 8 (NT wm + q) + 2t + e, column 64 wn + 8g + 4hh + i."""
    wn_, wm_, nt, bm, bn = tile(cfg)
    wn, wm, i, q, lane, d = np.meshgrid(np.arange(wn_), np.arange(wm_),
                                        np.arange(4), np.arange(nt),
                                        np.arange(32), np.arange(4),
                                        indexing="ij")
    g, t, hh, e = lane // 4, lane % 4, d // 2, d % 2
    rows = 8 * (nt * wm + q) + 2 * t + e
    cols = WARP_COLS * wn + 8 * g + 4 * hh + i
    part = np.zeros(acc.shape[:2] + (bm, bn), np.int64)
    part[:, :, rows, cols] = acc[:, :, wn, wm, i, q, lane, d]
    return part


def emulate(xq, wq, scale=None, b=None, act="identity", num_sms=SMS,
            chunk=128):
    """The kernel's y for int8 numpy operands: float32 of the sums when
    scale is None, else act(f32(sums) * scale + b) rounded twice."""
    m, k = xq.shape
    n = wq.shape[1]
    cfg, ranks = plan(m, n, k, num_sms)
    _, _, _, bm, bn = tile(cfg)
    bk, wk = slice_k(cfg), k_groups(cfg)
    tm, tn = -(-m // bm), -(-n // bn)
    total = np.zeros((tm, tn, bm, bn), np.int64)
    for rank in range(ranks):  # rank order, as the epilogue adds them
        kb, ke = rank_rows(rank, ranks, k)
        ns = -(-max(ke - kb, 0) // bk)
        # the rank's slices from kb; 0 past ke and outside the problem
        xr = np.zeros((tm * bm, ns * bk), np.int8)
        xr[:m, :ke - kb] = xq[:, kb:ke]
        wr = np.zeros((ns * bk, tn * bn), np.int8)
        wr[:ke - kb, :n] = wq[kb:ke]
        part = np.zeros_like(total)
        for c0 in range(0, ns, chunk):
            c1 = min(ns, c0 + chunk)
            a = a_fragments(wr[c0 * bk:c1 * bk], cfg)
            b_ = b_fragments(xr[:, c0 * bk:c1 * bk], cfg)
            # warp group g takes k32 steps g, g + WK, ... and stores its
            # accumulators to its own partial tile; the block adds them and
            # each rank's sums reach the group's owner, who adds them
            for group in range(wk):
                part += store_partial(mma(a, b_, np.arange(group, bk // 32,
                                                           wk)), cfg)
        assert np.abs(part).max(initial=0) < 2 ** 31  # no s32 wrap
        total += part
    assert np.abs(total).max(initial=0) < 2 ** 31
    sums = total.astype(np.int32).transpose(0, 2, 1, 3).reshape(
        tm * bm, tn * bn)[:m, :n]
    z = sums.astype(np.float32)
    if scale is None:
        return z
    z = (z * scale).astype(np.float32) + b
    return np.maximum(z, np.float32(0)) if act == "relu" else z


# ---------------------------------------------------------------------------
# the transposes, the fragment map, the layouts
# ---------------------------------------------------------------------------

def test_byte_perm_follows_the_cuda_selector():
    x, y = np.uint32(0x33221100), np.uint32(0x77665544)
    assert int(byte_perm(x, y, 0x5140)) == 0x55114400
    assert int(byte_perm(x, y, 0x7362)) == 0x77336622
    assert int(byte_perm(x, y, 0x3210)) == 0x33221100
    assert int(byte_perm(x, y, 0x7654)) == 0x77665544
    assert int(byte_perm(np.uint32(0x80), y, 0x8888)) == 0xFFFFFFFF


@pytest.mark.parametrize("seed", range(3))
def test_source_transpose_turns_rows_into_columns(seed):
    """The 8 ``__byte_perm`` of ``transpose4x4``: word i of the result holds
    byte i of words 0..3 (column i's four k), for any bytes."""
    assert len(_TRANSPOSE) == 8
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (1000, 4, 4), dtype=np.uint8)  # [row, col]
    rows = [_words(blocks[:, j]) for j in range(4)]
    cols = transpose4x4(rows)
    for i in range(4):
        np.testing.assert_array_equal(cols[i], _words(blocks[:, :, i]))


def test_fragment_maps_cover_each_element_once():
    """A 16 x 32, B 32 x 8 and the accumulator 16 x 8: every element in
    exactly one (lane, register, byte)."""
    for rows, cols, shape in ((A_ROW, A_K, (16, 32)), (B_K, B_COL, (32, 8)),
                              (D_ROW, D_COL, (16, 8))):
        seen = np.zeros(shape, int)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


@pytest.mark.parametrize("cfg", range(len(TILES)))
def test_one_slice_of_fragments_is_the_product(cfg):
    """One staged slice through the lanes' loads, the transposes, the
    decoded MMAs and the partial-tile store equals x . w of that slice, at
    every tile config (columns and rows of every warp placed); each k32
    step alone is that step's product."""
    _, _, _, bm, bn = tile(cfg)
    bk = slice_k(cfg)
    rng = np.random.default_rng(cfg)
    xp = rng.integers(-128, 128, (bm, bk), dtype=np.int8)
    wp = rng.integers(-128, 128, (bk, bn), dtype=np.int8)
    a, b = a_fragments(wp, cfg), b_fragments(xp, cfg)
    got = store_partial(mma(a, b), cfg)[0, 0]
    np.testing.assert_array_equal(got, xp.astype(np.int64) @ wp)
    for step in range(bk // 32):
        k = slice(32 * step, 32 * step + 32)
        np.testing.assert_array_equal(
            store_partial(mma(a, b, [step]), cfg)[0, 0],
            xp[:, k].astype(np.int64) @ wp[k])


@pytest.mark.parametrize("cfg", range(len(TILES)))
def test_staged_rows_do_not_overlap_and_spread_the_banks(cfg):
    """Staged rows keep their bytes contiguous (one bulk copy a row) and do
    not overlap; a half-warp's 8-byte fragment loads (lanes 16h .. 16h+15
    at rows 4t + j) touch 32 distinct banks at every tile config."""
    _, _, _, _, bn = tile(cfg)
    bk = slice_k(cfg)
    starts = w_row(bn, np.arange(bk))
    assert (starts % 16 == 0).all()
    assert (np.diff(starts) >= bn).all()
    worst = 0
    for kk in range(0, bk, 32):
        for wn in range(bn // WARP_COLS):
            for j in range(4):
                for half in range(2):
                    lanes = LANE[16 * half:16 * half + 16]
                    addr = (w_row(bn, kk + 4 * T[lanes] + j) + WARP_COLS * wn
                            + 8 * G[lanes])
                    banks = np.concatenate([(addr // 4) % 32,
                                            (addr // 4 + 1) % 32])
                    worst = max(worst,
                                int(np.bincount(banks, minlength=32).max()))
    assert worst == 1


@pytest.mark.parametrize("cfg", range(len(TILES)))
def test_xq_fragment_loads_hit_distinct_banks(cfg):
    """B fragments: lane (g, t) reads word t of row g; the row stride of
    slice_k + kXPad bytes puts the warp's 32 words in 32 banks."""
    ld = slice_k(cfg) + X_PAD
    assert ld % 16 == 0  # cp.async destinations stay aligned
    words = (G * ld + 4 * T) // 4
    assert len(set((words % 32).tolist())) == 32


@pytest.mark.parametrize("cfg", range(len(TILES)))
def test_shared_memory_of_each_config_fits(cfg):
    """The ring (kStages slices of wq and xq) and the int32 partial tile it
    becomes fit a block's 227 KB, every slot 16-byte aligned."""
    _, _, _, bm, bn = tile(cfg)
    bk = slice_k(cfg)
    stage = int(w_row(bn, bk)) + bm * (bk + X_PAD)
    part = k_groups(cfg) * bm * (bn + 4) * 4
    inbox = (bm * bn // 4 + MAX_RANKS) * 16
    assert stage % 16 == 0 and part % 16 == 0
    assert max(STAGES * stage, part) + inbox <= 232448
    assert 32 * TILES[cfg][0] * TILES[cfg][1] * k_groups(cfg) == 128


class MBarrier:
    """An mbarrier as the ring uses it: a phase completes after ``count``
    arrivals; ``try_wait(parity)`` is true once the phase of that parity
    has completed (at phase 0, parity 1 counts as completed)."""

    def __init__(self, count: int):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def try_wait(self, parity: int) -> bool:
        return (self.phase & 1) != parity


@pytest.mark.parametrize("seed", range(6))
def test_ring_handover_never_overwrites_a_slot_in_use(seed):
    """The kernel's protocol under random interleavings: the producer
    stages slice s into slot s % kStages after waiting on the slot's empty
    barrier at parity (s / kStages - 1) & 1 (s >= kStages), then arrives on
    its full barrier; each of the 4 MMA warps waits on full at parity
    (s / kStages) & 1, reads the slot and arrives on empty. Every warp reads
    every slice in order and no slot is overwritten before all 4 read it."""
    rng = np.random.default_rng(seed)
    warps, nk = 4, 23
    full = [MBarrier(1) for _ in range(STAGES)]
    empty = [MBarrier(warps) for _ in range(STAGES)]
    slot_holds = [None] * STAGES
    readers = [set() for _ in range(STAGES)]
    produced, consumed = 0, [0] * warps
    while min(consumed) < nk:
        who = rng.integers(0, warps + 1)
        if who == warps:  # the producer's next step
            s = produced
            if s >= nk:
                continue
            slot = s % STAGES
            if s >= STAGES and not empty[slot].try_wait((s // STAGES - 1) & 1):
                continue
            if slot_holds[slot] is not None:
                assert readers[slot] == set(range(warps)), "overwrote a slot in use"
            slot_holds[slot], readers[slot] = s, set()
            full[slot].arrive()
            produced += 1
        else:
            s = consumed[who]
            if s >= nk:
                continue
            slot = s % STAGES
            if not full[slot].try_wait((s // STAGES) & 1):
                continue
            assert slot_holds[slot] == s
            readers[slot].add(who)
            empty[slot].arrive()
            consumed[who] += 1
    assert produced == nk


# ---------------------------------------------------------------------------
# the split: a function of the shape, every k once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_k_partition_takes_every_row_once(ranks):
    """Ranks take contiguous row ranges of whole kUnit-row units that cover
    [0, K) once; with fewer units than ranks some ranks take none (and still
    reach both cluster barriers: the kernel runs its loop zero times)."""
    for k in list(range(0, 300, 7)) + [1001, 4096, 6400, 20001, 131071]:
        taken, empty = [], 0
        for rank in range(ranks):
            kb, ke = rank_rows(rank, ranks, k)
            assert kb % UNIT == 0
            taken += list(range(kb, ke))
            empty += ke <= kb
        assert taken == list(range(k))
        if -(-k // UNIT) < ranks:
            assert empty == ranks - -(-k // UNIT)


@pytest.mark.parametrize("cfg", range(len(TILES)))
def test_epilogue_groups_cover_the_tile_once(cfg):
    """Rank r adds and stores groups [r G / R, (r+1) G / R) of the tile's
    valid rows: every 4-column group of every valid row once."""
    _, _, _, bm, bn = tile(cfg)
    for rows in sorted({1, 3, bm // 2, bm}):
        groups = rows * (bn // 4)
        for ranks in (1, 2, 4, 8):
            seen = np.zeros(groups, int)
            for rank in range(ranks):
                seen[rank * groups // ranks:(rank + 1) * groups // ranks] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_each_group_lands_in_its_owners_inbox_once(ranks):
    """A rank stores group gi's sum in rank owner = (gi R + R - 1) / G, slot
    sender * ceil(G / R) + gi - first (first = owner G / R): the owner is
    the rank whose share [o G / R, (o+1) G / R) holds gi, no two (sender,
    group) pairs share a slot, and every slot lies in the kGroups +
    kMaxRanks the kernel sets aside."""
    for cfg in range(len(TILES)):
        _, _, _, bm, bn = tile(cfg)
        for rows in sorted({1, 2, 3, 5, bm // 2, bm}):
            groups = rows * bn // 4
            share = -(-groups // ranks)
            used = set()
            for gi in range(groups):
                owner = (gi * ranks + ranks - 1) // groups
                first = owner * groups // ranks
                assert first <= gi < (owner + 1) * groups // ranks
                for sender in range(ranks):
                    slot = (owner, sender * share + gi - first)
                    assert slot not in used and gi - first < share
                    assert slot[1] < bm * bn // 4 + MAX_RANKS
                    used.add(slot)


RESNET_SHAPES = [(1568, 512, 2048), (1568, 1024, 512), (1568, 1024, 2048),
                 (1568, 2048, 512), (6272, 256, 1024), (6272, 512, 256),
                 (6272, 512, 1024), (6272, 1024, 256), (25088, 128, 512),
                 (25088, 256, 128), (25088, 256, 512), (25088, 512, 128),
                 (100352, 64, 64), (100352, 64, 256), (100352, 256, 64)]


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32])
def test_serving_buckets_split_k_over_clusters_of_two(m):
    """AlexNet's sites at every bucket: one row tile holds the batch (each
    weight byte read once), 64 column tiles of 64, 2 ranks: 128 blocks in
    64 clusters (an H100 places 66 clusters of 2 one block an SM, but only
    15 of 8); the ranks take equal halves of K."""
    for k in (6400, 4096):
        cfg, ranks = plan(m, 4096, k)
        _, _, _, bm, bn = tile(cfg)
        assert bm >= m and bm == 8 * (1 if m <= 8 else 2 if m <= 16 else 4)
        assert (4096 // bn, ranks) == (64, 2)
        assert [ke - kb for kb, ke in (rank_rows(r, ranks, k)
                                       for r in range(ranks))] == [k // 2] * 2


def test_plan_depends_on_the_shape_alone():
    """The same shape gets the same plan; ResNet-50's 1x1 shapes fill the
    card with tiles alone (no split), N = 64 takes the 128 x 64 tile."""
    for m, k, n in RESNET_SHAPES:
        cfg, ranks = plan(m, n, k)
        assert (cfg, ranks) == plan(m, n, k) and ranks == 1
        assert cfg == (4 if n <= WARP_COLS else 3)
    assert plan(3, 75, 1001) == (0, 4)  # chip_smoke's split ragged shape
    assert plan(1, 4096, 0)[1] == 1


def test_wrapper_asks_the_library_once_per_shape(monkeypatch):
    """The plan is cached per (m, n, k, device): a second launch of a shape
    makes no plan call; the split-K workspace export is gone."""
    calls = []

    class Lib:
        dl4j_matmul_bias_act_int8 = object()

        @staticmethod
        def dl4j_matmul_int8_plan(m, n, k, device):
            calls.append((m, n, k, device))
            return 16 * plan(m, n, k)[0] + plan(m, n, k)[1]

    monkeypatch.setattr(impls, "_INT8_PLANS", {})
    monkeypatch.setattr(impls, "_int8_library", lambda: Lib)
    first = impls._int8_plan(32, 4096, 6400, 0)
    assert impls._int8_plan(32, 4096, 6400, 0) == first
    assert first == (Lib.dl4j_matmul_bias_act_int8, 2 * 16 + 2)
    impls._int8_plan(32, 4096, 6400, 1)
    impls._int8_plan(1, 4096, 6400, 0)
    assert calls == [(32, 4096, 6400, 0), (32, 4096, 6400, 1),
                     (1, 4096, 6400, 0)]
    assert "dl4j_matmul_int8_splits" not in impls._INT8_SIGNATURES
    assert "dl4j_matmul_int8_splits" not in SOURCE
    assert "__dp4a" not in SOURCE and "m16n8k32.row.col.s32.s8.s8.s32" in SOURCE


def test_failed_plan_raises(monkeypatch):
    class Lib:
        dl4j_matmul_bias_act_int8 = object()

        @staticmethod
        def dl4j_matmul_int8_plan(m, n, k, device):
            return -1

    monkeypatch.setattr(impls, "_INT8_PLANS", {})
    monkeypatch.setattr(impls, "_int8_library", lambda: Lib)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        impls._int8_plan(4, 8, 16, 0)
    assert impls._INT8_PLANS == {}


# ---------------------------------------------------------------------------
# the emulated kernel against the plain version and the Pallas kernel
# ---------------------------------------------------------------------------

# (m, k, n): every serving bucket at AlexNet's K with N cut to 320 (one full
# 256-column tile and a partial one); chip_smoke's ragged shapes; large M on
# both large-M configs, with and without a cluster split; K at INT8_K_MAX
SHAPES = ([(m, 6400, 320) for m in (1, 2, 4, 8, 16, 32)]
          + [(m, 4096, 320) for m in (1, 8, 32)]
          + [(333, 27, 75), (20001, 77, 257), (3, 1001, 75)]
          + [(100, 256, 64), (96, 128, 200), (70, 2048, 130), (40, 1024, 64),
             (5, impls.INT8_K_MAX, 40)])


def _operands(m, k, n):
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-128, 128, (k, n), dtype=np.int8)
    xq[0] = -128  # the largest sum: 128 * 128 * K
    wq[:, 0] = -128
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return xq, wq, scale, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_sums_equal_plain_and_pallas(shape):
    """The int32 sums (identity, scale 1, bias 0) bit for bit against the
    plain version and the JAX Pallas kernel in interpret mode."""
    m, k, n = shape
    xq, wq, _, _ = _operands(m, k, n)
    got = emulate(xq, wq)
    assert got[0, 0] == np.float32(128 * 128 * k)
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    plain = impls.matmul_bias_act_int8_plain(*_t(xq, wq, ones, zeros),
                                             Activation.IDENTITY).numpy()
    np.testing.assert_array_equal(got, plain)
    pallas = np.asarray(jimpls.matmul_bias_act_int8(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ones),
        jnp.asarray(zeros), JAct("identity"), (m, n, k), True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("shape", SHAPES[:9] + SHAPES[9:12],
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_epilogue_equals_plain(shape, act):
    """act(f32(sums) * scale + b), the product and the bias rounded one
    after the other, bit for bit against the plain version."""
    m, k, n = shape
    xq, wq, scale, b = _operands(m, k, n)
    got = emulate(xq, wq, scale, b, act)
    plain = impls.matmul_bias_act_int8_plain(*_t(xq, wq, scale, b),
                                             Activation(act)).numpy()
    np.testing.assert_array_equal(got, plain)


def test_emulation_sees_a_wrong_fragment_map():
    """The check has teeth: reading the B operand's k halves swapped (a
    plausible slip in the fragment map) changes the sums."""
    cfg = 0
    bk = slice_k(cfg)
    xq, wq, _, _ = _operands(8, bk, 64)
    assert plan(8, 64, bk) == (cfg, 1)
    good = emulate(xq, wq)
    a = a_fragments(wq, cfg)
    b = b_fragments(xq, cfg)[..., ::-1]
    bad = store_partial(mma(a, b.copy()), cfg)[0, 0]
    assert not np.array_equal(bad.astype(np.float32), good)
