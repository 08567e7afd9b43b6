"""Kernel registry: the hand-written Hopper kernels, their envelopes, tuned
selection.

Counterpart of the JAX package's ``kernels/registry.py``, with the same
kernel ids, envelope keys and tuning digests. Each registered
:class:`Kernel` declares

- a **shape/dtype envelope** (``supports(env)``): the concrete problems
  its launcher takes;
- a **tiling space** (``candidates(env)``) the autotuner
  (:mod:`kernels.tuner`) sweeps per concrete ``(shape, dtype, backend)``,
  always holding the launcher's own rule (``default_tiling(env)``, first);
- its **plain version** (``reference(env)``), which every candidate must
  match;
- ``build(env, tiling)``: the wrapper's call at one
  tiling, on the card the kernel, on the CPU its plain version.

Selection (:meth:`KernelRegistry.select`) is a tuning-cache lookup. A
TUNED envelope runs its winner. An untuned envelope, or a cached winner
that ``tiling_ok`` refuses, runs the kernel at its default tiling, never
the stock op: a ``use_kernels`` route never degrades. That differs from
the JAX package, where untuned means stock XLA. The per-kernel **tuning
digest** (8 hex digits over the winner table and the kernel version,
epoch-memoized) makes up ``cache_tag``'s ``kern:<id>:<digest>`` tokens,
the same string the JAX package computes for the same winners.

Tilings by kernel (the launchers in ``csrc/`` take each as an argument;
0 there means the default rule):

- ``matmul_bias_act``: ``(BM, BN)`` in {(128, 64), (64, 64)};
- ``conv_bn_act`` (``matmul_stats``): ``(block_m,)`` in {128, 64};
- ``matmul_bias_act_int8``: ``(tile config, cluster ranks)``;
- ``flash_attention``: ``(block_q, block_k)``, the one ``FlashCfg`` pair
  of the head size;
- ``paged_decode_attention``: ``(page,)``, ``min(64, S)`` and the pages
  of {64, 32, 16, 8} that divide S.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import impls, tuner

H100_SMS = 132  # the SM count envelopes planned off the card assume

# csrc/matmul_bias_act.cu and csrc/matmul_stats.cu: the two block tiles
_GEMM_TILES = ((128, 64), (64, 64))

# csrc/matmul_bias_act_int8.cu: (warps along N, warps along M, n8 tiles a
# warp, warps along K) of each tile config, and the K split's limits
INT8_TILES = ((1, 1, 1, 4), (1, 1, 2, 4), (1, 1, 4, 4), (2, 2, 4, 1),
              (1, 4, 4, 1))
INT8_WARP_COLS = 64
INT8_UNIT = 32
INT8_MAX_RANKS = 8
INT8_MIN_ROWS = 256
INT8_BLOCKS_PER_SM = 1
INT8_ONE_TILE_CONFIGS = 3  # configs 0-2 hold the whole batch in one row tile
_GRID_Y_MAX = 65535
_INT_MAX = 2 ** 31 - 1

# csrc/paged_decode_attention.cu: pages the tuner sweeps, at most kMaxPage
PAGE_SWEEP = (64, 32, 16, 8)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_FLOAT_DTYPES = ("float32", "bfloat16")


class MatmulEnvelope(NamedTuple):
    """One concrete matmul-class problem: [M, K] x [K, N] in ``dtype`` on
    ``backend`` ("cuda" = the card's kernel, "cpu" = its plain version),
    with an elementwise activation in the epilogue. A tuple, so a route's
    selection lookup hashes it without formatting a string."""

    m: int
    k: int
    n: int
    dtype: str
    backend: str
    act: str = "identity"

    @property
    def key(self) -> str:
        return (f"{self.backend}:m{self.m}:k{self.k}:n{self.n}"
                f":{self.dtype}:{self.act}")

    @property
    def shape_bucket(self) -> str:
        """The telemetry label: shape class without backend/act noise."""
        return f"m{self.m}_k{self.k}_n{self.n}"


class AttentionEnvelope(NamedTuple):
    """One concrete attention problem. ``tq`` is the query length (1 for
    single-token decode), ``tk`` the key length: for the paged decode
    kernel the KV cache bucket, so every bucket is its own envelope.
    ``masked`` marks a key-padding mask."""

    b: int
    h: int
    tq: int
    tk: int
    d: int
    dtype: str
    backend: str
    causal: bool = True
    masked: bool = False

    @property
    def key(self) -> str:
        return (f"{self.backend}:b{self.b}:h{self.h}:tq{self.tq}"
                f":tk{self.tk}:d{self.d}:{self.dtype}"
                f":c{int(self.causal)}:m{int(self.masked)}")

    @property
    def shape_bucket(self) -> str:
        return f"b{self.b}_h{self.h}_tq{self.tq}_tk{self.tk}_d{self.d}"


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_sms(backend: str) -> int:
    """The SM count the default rules read: the current card's for a
    "cuda" envelope (what the launcher reads), an H100's otherwise."""
    if backend == "cuda" and torch.cuda.is_available():
        return _card_sms(torch.cuda.current_device())
    return H100_SMS


def wide_tiles(m: int, n: int, sms: int) -> bool:
    """``tc::wide_tiles`` (csrc/tc_gemm.cuh): 128 x 64 tiles where the
    problem has two of them for each SM."""
    return -(-m // 128) * -(-n // 64) >= 2 * sms


def _device(env) -> torch.device:
    if env.backend == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _generator(env, seed: int) -> torch.Generator:
    return torch.Generator(device=_device(env)).manual_seed(seed)


def _randn(env, gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device=_device(env))
    return (x * scale).to(dtype)


class Kernel:
    """Base registry entry. ``version`` participates in the tuning digest,
    so a kernel change can invalidate every winner tuned for the old one."""

    kernel_id: str = ""
    version: int = 1

    def supports(self, env) -> bool:
        raise NotImplementedError

    def candidates(self, env, limit: Optional[int] = None):
        """The legal tilings, the default first (so a capped sweep keeps
        it)."""
        raise NotImplementedError

    def default_tiling(self, env) -> Tuple[int, ...]:
        """The tiling the launcher's own rule (argument 0) takes."""
        raise NotImplementedError

    def build(self, env, tiling):
        """-> callable over :meth:`make_inputs`-shaped args running the
        wrapper at ``tiling``."""
        raise NotImplementedError

    def reference(self, env):
        """-> callable over the same args running the plain version."""
        raise NotImplementedError

    def make_inputs(self, env, seed: int = 0):
        """Seeded inputs for one envelope (a ``torch.Generator`` on the
        envelope's device)."""
        raise NotImplementedError

    def tiling_ok(self, env, tiling) -> bool:
        """Whether a cached winner still legally covers ``env``: the guard
        :meth:`KernelRegistry.select` runs before trusting a hand-edited
        or cross-version entry. Default: one of this kernel's candidates."""
        return tuple(tiling) in {tuple(t) for t in self.candidates(env)}


def _default_first(default, tilings, limit):
    out = [tuple(default)] + [tuple(t) for t in tilings
                              if tuple(t) != tuple(default)]
    return out[:limit] if limit else out


class _FloatGemmKernel(Kernel):
    """The float GEMMs' shared envelope: float32 or bfloat16, any
    positive M, K, N (the kernels mask ragged edges)."""

    def supports(self, env) -> bool:
        return (isinstance(env, MatmulEnvelope)
                and env.dtype in _FLOAT_DTYPES
                and env.m > 0 and env.k > 0 and env.n > 0)

    def _wide(self, env) -> bool:
        return wide_tiles(env.m, env.n, num_sms(env.backend))

    def _gemm_inputs(self, env, seed):
        gen = _generator(env, seed)
        dt = _DTYPES[env.dtype]
        x = _randn(env, gen, (env.m, env.k), dt)
        w = _randn(env, gen, (env.n, env.k), dt, env.k ** -0.5)
        return x, w, gen


class MatmulBiasActKernel(_FloatGemmKernel):
    """matmul + bias + elementwise activation in one pass: the dense /
    1x1-conv forward (``impls.matmul_bias_act``). Tiling ``(BM, BN)``;
    every tiling gives the same bits (each output walks the same K
    steps)."""

    kernel_id = "matmul_bias_act"
    version = 1

    def default_tiling(self, env):
        return _GEMM_TILES[0] if self._wide(env) else _GEMM_TILES[1]

    def candidates(self, env, limit: Optional[int] = None):
        return _default_first(self.default_tiling(env), _GEMM_TILES, limit)

    def build(self, env, tiling):
        from deeplearning4j_tpu_torch.conf.activations import Activation

        act = Activation(env.act)
        tiling = tuple(int(t) for t in tiling)

        def fn(x, w, b):
            return impls.matmul_bias_act(x, w, b, act, tiling)

        return fn

    def reference(self, env):
        from deeplearning4j_tpu_torch.conf.activations import Activation

        act = Activation(env.act)

        def ref(x, w, b):
            return impls.matmul_bias_act_plain(x, w, b, act)

        return ref

    def make_inputs(self, env, seed: int = 0):
        x, w, gen = self._gemm_inputs(env, seed)
        return x, w, _randn(env, gen, (env.n,), _DTYPES[env.dtype])


class ConvBnActKernel(_FloatGemmKernel):
    """Fused 1x1-conv + batch-norm statistics (``impls.matmul_stats``):
    y and per-column sum / sum of squares in one pass. Tiling
    ``(block_m,)``: y is the same bits under either, the statistics group
    their partial sums by block_m rows."""

    kernel_id = "conv_bn_act"
    version = 1

    def default_tiling(self, env):
        return (128,) if self._wide(env) else (64,)

    def candidates(self, env, limit: Optional[int] = None):
        return _default_first(self.default_tiling(env),
                              [(bm,) for bm, _ in _GEMM_TILES], limit)

    def build(self, env, tiling):
        tiling = tuple(int(t) for t in tiling)

        def fn(x, w):
            return impls.matmul_stats(x, w, tiling)

        return fn

    def reference(self, env):
        return impls.matmul_stats_plain

    def make_inputs(self, env, seed: int = 0):
        x, w, _ = self._gemm_inputs(env, seed)
        return x, w


def int8_block_rows(cfg: int) -> int:
    return 8 * INT8_TILES[cfg][2] * INT8_TILES[cfg][1]


def int8_block_cols(cfg: int) -> int:
    return INT8_WARP_COLS * INT8_TILES[cfg][0]


def int8_tile_config(m: int, n: int) -> int:
    """``tile_config`` of csrc/matmul_bias_act_int8.cu."""
    if m <= 8:
        return 0
    if m <= 16:
        return 1
    if m <= 32:
        return 2
    return 3 if n > INT8_WARP_COLS else 4


def _int8_tiles(cfg, m, n) -> int:
    return -(-m // int8_block_rows(cfg)) * -(-n // int8_block_cols(cfg))


def int8_cluster_ranks(cfg: int, m: int, n: int, k: int, sms: int) -> int:
    """``cluster_ranks`` of csrc/matmul_bias_act_int8.cu: doubled up to
    kMaxRanks while the grid keeps kBlocksPerSm blocks an SM and every
    rank keeps kMinRows rows of K."""
    tiles = _int8_tiles(cfg, m, n)
    units = -(-k // INT8_UNIT)
    ranks = 1
    while (ranks < INT8_MAX_RANKS
           and tiles * 2 * ranks <= INT8_BLOCKS_PER_SM * sms
           and units >= 2 * ranks * (INT8_MIN_ROWS // INT8_UNIT)):
        ranks *= 2
    return ranks


def _int8_legal(cfg, ranks, m, n, k) -> bool:
    """What the launcher takes: a config of kTiles, power-of-two ranks up
    to kMaxRanks with kMinRows rows of K each once K is split, and a grid
    within its limits."""
    units = -(-k // INT8_UNIT)
    return (0 <= cfg < len(INT8_TILES)
            and ranks in (1, 2, 4, 8) and ranks <= INT8_MAX_RANKS
            and (ranks == 1
                 or units >= ranks * (INT8_MIN_ROWS // INT8_UNIT))
            and -(-n // int8_block_cols(cfg)) <= _GRID_Y_MAX
            and -(-m // int8_block_rows(cfg)) * ranks <= _INT_MAX)


class Int8MatmulBiasActKernel(Kernel):
    """Quantized serving matmul (``impls.matmul_bias_act_int8``): int8 x
    int8 -> exact int32 sums, the f32 scale / bias / activation epilogue
    in the same launch. Tiling ``(tile config, cluster ranks)``: the
    configs of ``kTiles`` that can hold M (0-2 hold the whole batch in one
    row tile, 3-4 tile any M) times the K split over 1, 2, 4 or 8 cluster
    ranks. The sums are exact, so every tiling gives the same bits."""

    kernel_id = "matmul_bias_act_int8"
    version = 1

    def supports(self, env) -> bool:
        return (isinstance(env, MatmulEnvelope) and env.dtype == "int8"
                and env.m > 0 and env.k > 0 and env.n > 0
                and env.k <= impls.INT8_K_MAX
                and _int8_legal(*self.default_tiling(env), env.m, env.n,
                                env.k))

    def default_tiling(self, env):
        cfg = int8_tile_config(env.m, env.n)
        return (cfg, int8_cluster_ranks(cfg, env.m, env.n, env.k,
                                        num_sms(env.backend)))

    def candidates(self, env, limit: Optional[int] = None):
        cfgs = [c for c in range(len(INT8_TILES))
                if c >= INT8_ONE_TILE_CONFIGS or int8_block_rows(c) >= env.m]
        legal = [(c, r) for c in cfgs for r in (1, 2, 4, 8)
                 if _int8_legal(c, r, env.m, env.n, env.k)]
        return _default_first(self.default_tiling(env), legal, limit)

    def build(self, env, tiling):
        from deeplearning4j_tpu_torch.conf.activations import Activation

        act = Activation(env.act)
        tiling = tuple(int(t) for t in tiling)

        def fn(xq, wq, scale, b):
            return impls.matmul_bias_act_int8(xq, wq, scale, b, act, tiling)

        return fn

    def reference(self, env):
        from deeplearning4j_tpu_torch.conf.activations import Activation

        act = Activation(env.act)

        def ref(xq, wq, scale, b):
            return impls.matmul_bias_act_int8_plain(xq, wq, scale, b, act)

        return ref

    def make_inputs(self, env, seed: int = 0):
        gen = _generator(env, seed)
        dev = _device(env)
        xq = torch.randint(-127, 128, (env.m, env.k), generator=gen,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (env.k, env.n), generator=gen,
                           device=dev, dtype=torch.int8)
        scale = (torch.rand((env.n,), generator=gen, device=dev) * 1.5
                 + 0.5) / 127
        b = torch.randn((env.n,), generator=gen, device=dev)
        return xq, wq, scale, b


def _attention_supports(env) -> bool:
    from deeplearning4j_tpu_torch.ops.attention import head_dim_supported

    return (isinstance(env, AttentionEnvelope)
            and env.dtype in _FLOAT_DTYPES
            and env.b > 0 and env.h > 0 and env.tq > 0 and env.tk > 0
            and head_dim_supported(env.d))


class FlashAttentionKernel(Kernel):
    """The flash forward (``ops.attention.flash_attention``): online
    softmax over key tiles, never the [Tq, Tk] score matrix. Tiling
    ``(block_q, block_k)``: the launcher instantiates one pair a head size
    (``FlashCfg``, which the backward's visited-key rule shares), so there
    is one candidate and tuning records it, as the JAX package's small-T
    problems collapse to one candidate."""

    kernel_id = "flash_attention"
    version = 1

    def supports(self, env) -> bool:
        return _attention_supports(env)

    def default_tiling(self, env):
        from deeplearning4j_tpu_torch.ops.attention import flash_tiles

        return tuple(flash_tiles(env.d))

    def candidates(self, env, limit: Optional[int] = None):
        return _default_first(self.default_tiling(env), [], limit)

    def build(self, env, tiling):
        from deeplearning4j_tpu_torch.ops import attention as A

        tiling = tuple(int(t) for t in tiling)
        causal = env.causal

        def fn(q, k, v, key_mask=None):
            return A.flash_attention(q, k, v, key_mask, causal=causal,
                                     tiling=tiling)

        return fn

    def reference(self, env):
        from deeplearning4j_tpu_torch.ops import attention as A

        causal = env.causal

        def ref(q, k, v, key_mask=None):
            return A.flash_attention_plain(q, k, v, key_mask, causal)[0]

        return ref

    def make_inputs(self, env, seed: int = 0):
        gen = _generator(env, seed)
        dt = _DTYPES[env.dtype]
        q = _randn(env, gen, (env.b, env.h, env.tq, env.d), dt)
        k = _randn(env, gen, (env.b, env.h, env.tk, env.d), dt)
        v = _randn(env, gen, (env.b, env.h, env.tk, env.d), dt)
        if not env.masked:
            return q, k, v
        # ragged key-padding mask: every row keeps at least one key
        lens = torch.randint(1, env.tk + 1, (env.b,), generator=gen,
                             device=_device(env))
        km = (torch.arange(env.tk, device=_device(env))[None, :]
              < lens[:, None]).float()
        return q, k, v, km


class PagedDecodeAttentionKernel(Kernel):
    """Single-token decode against the KV cache
    (``ops.attention.paged_decode_attention``): split-KV over 8-block
    clusters, pages wholly past ``positions[b]`` neither read nor computed.
    Tiling ``(page,)``. The envelope is the route's qualifier: a cache
    bucket S that the largest page, ``min(64, S)`` (the launcher's
    kMaxPage), divides; that page is the default, and the candidates are
    it and the JAX sweep's pages up to 64 that divide S. On the decoder's
    power-of-two buckets these are JAX's candidates, capped at 64."""

    kernel_id = "paged_decode_attention"
    version = 1

    def supports(self, env) -> bool:
        return (_attention_supports(env) and env.tq == 1
                and env.tk % min(max(PAGE_SWEEP), env.tk) == 0)

    def default_tiling(self, env):
        return (min(max(PAGE_SWEEP), env.tk),)

    def candidates(self, env, limit: Optional[int] = None):
        return _default_first(
            self.default_tiling(env),
            [(p,) for p in PAGE_SWEEP if p <= env.tk and env.tk % p == 0],
            limit)

    def build(self, env, tiling):
        from deeplearning4j_tpu_torch.ops import attention as A

        page = int(tiling[0])

        def fn(q, k_cache, v_cache, positions):
            return A.paged_decode_attention(q, k_cache, v_cache, positions,
                                            page=page)

        return fn

    def reference(self, env):
        from deeplearning4j_tpu_torch.ops import attention as A

        def ref(q, k_cache, v_cache, positions):
            return A.paged_decode_attention_plain(q, k_cache, v_cache,
                                                  positions)

        return ref

    def make_inputs(self, env, seed: int = 0):
        gen = _generator(env, seed)
        dt = _DTYPES[env.dtype]
        q = _randn(env, gen, (env.b, env.h, env.d), dt)
        kc = _randn(env, gen, (env.b, env.tk, env.h, env.d), dt)
        vc = _randn(env, gen, (env.b, env.tk, env.h, env.d), dt)
        pos = torch.randint(0, env.tk, (env.b,), generator=gen,
                            device=_device(env), dtype=torch.int32)
        return q, kc, vc, pos


@dataclasses.dataclass(frozen=True)
class Selection:
    """One resolved routing decision: the tiling to run and whether it is
    a tuned winner (``tuned``) or the kernel's default."""

    kernel: Kernel
    env: object
    tiling: Tuple[int, ...]
    tuned: bool = True


class KernelRegistry:
    """Process-global name -> :class:`Kernel` table + tuned selection +
    epoch-memoized selections and tuning digests."""

    def __init__(self, cache: Optional[tuner.TuningCache] = None):
        self._kernels: Dict[str, Kernel] = {}
        self._cache = cache if cache is not None else tuner.TUNING
        self._digests: Dict[str, Tuple[int, str]] = {}
        self._tag_memo: Optional[Tuple[int, Tuple[str, ...], str]] = None
        self._selected: Tuple[int, dict] = (-1, {})
        self._lock = threading.Lock()

    @property
    def tuning(self) -> tuner.TuningCache:
        return self._cache

    def register(self, kernel: Kernel) -> Kernel:
        with self._lock:
            self._kernels[kernel.kernel_id] = kernel
            self._digests.pop(kernel.kernel_id, None)
            self._tag_memo = None
            self._selected = (-1, {})
        return kernel

    def get(self, kernel_id: str) -> Optional[Kernel]:
        return self._kernels.get(kernel_id)

    def ids(self) -> List[str]:
        return sorted(self._kernels)

    def select(self, kernel_id: str, env) -> Optional[Selection]:
        """The tiling one envelope runs at: its tuned winner, else (untuned,
        or a winner ``tiling_ok`` refuses) the kernel's default; None when
        the kernel does not support the envelope (the route runs the stock
        op). Memoized per (kernel id, envelope) against the tuning-cache
        epoch, so a routed call costs one dict lookup; a tuned selection
        is counted (``dl4j_kernel_selected_total``) once per envelope per
        epoch, when it is resolved."""
        epoch, memo = self._selected
        if epoch != self._cache.epoch:
            with self._lock:
                epoch = self._cache.epoch
                memo = {}
                self._selected = (epoch, memo)
        key = (kernel_id, env)
        try:
            return memo[key]
        except KeyError:
            pass
        sel = self._resolve(kernel_id, env)
        memo[key] = sel
        if sel is not None and sel.tuned:
            from deeplearning4j_tpu_torch import telemetry

            telemetry.record_kernel_selected(kernel_id, env.shape_bucket)
            telemetry.record_tuning_cache(self._cache.hits,
                                          self._cache.entries())
        return sel

    def _resolve(self, kernel_id: str, env) -> Optional[Selection]:
        kernel = self._kernels.get(kernel_id)
        if kernel is None or not kernel.supports(env):
            return None
        win = self._cache.winner(kernel_id, env.key)
        if win is not None:
            tiling = tuple(int(t) for t in win.get("tiling", ()))
            if kernel.tiling_ok(env, tiling):
                return Selection(kernel, env, tiling, True)
            # a hand-edited / cross-version winner that no longer covers
            # the problem: refused, the kernel runs at its default
        return Selection(kernel, env, tuple(kernel.default_tiling(env)),
                         False)

    def tuning_digest(self, kernel_id: str) -> str:
        """8-hex digest over the kernel's current winner table (+ its
        version), the JAX package's hashing; memoized against the
        tuning-cache epoch."""
        epoch = self._cache.epoch
        with self._lock:
            memo = self._digests.get(kernel_id)
            if memo is not None and memo[0] == epoch:
                return memo[1]
        kernel = self._kernels.get(kernel_id)
        payload = {
            "version": getattr(kernel, "version", 0),
            "winners": self._cache.winners(kernel_id),
        }
        d = hashlib.sha256(
            json.dumps(payload, sort_keys=True,
                       separators=(",", ":")).encode()).hexdigest()[:8]
        with self._lock:
            self._digests[kernel_id] = (epoch, d)
        return d

    def cache_tag(self) -> str:
        """The ``:kern:<id>:<digest>`` token string, one token per
        registered kernel, so retuning any kernel changes it. Memoized
        against the tuning-cache epoch."""
        epoch = self._cache.epoch
        ids = tuple(self.ids())
        with self._lock:
            memo = self._tag_memo
            if memo is not None and memo[0] == epoch and memo[1] == ids:
                return memo[2]
        tag = "".join(f":kern:{kid}:{self.tuning_digest(kid)}"
                      for kid in ids)
        with self._lock:
            self._tag_memo = (epoch, ids, tag)
        return tag


REGISTRY = KernelRegistry()
REGISTRY.register(MatmulBiasActKernel())
REGISTRY.register(Int8MatmulBiasActKernel())
REGISTRY.register(ConvBnActKernel())
REGISTRY.register(FlashAttentionKernel())
REGISTRY.register(PagedDecodeAttentionKernel())
