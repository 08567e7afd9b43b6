// int8 dense / 1x1-convolution forward for Hopper:
//   y[M,N] = act(float(int32 sum_k xq[M,K] * wq[K,N]) * scale[N] + b[N]), float32 out.
//
// Replaces the Pallas kernel deeplearning4j_tpu/kernels/impls.py::matmul_bias_act_int8
// (_mm_bias_act_q8_kernel), which runs the int8 product on the TPU's matrix unit into
// an int32 VMEM accumulator and the scale / bias / activation in the last K block.
// xq is the quantized activation (quantize_input, outside the kernel), wq the
// quantized weight in the contract layout [K, N], scale and b the per-column
// effective scale and bias of nn/inference_opt.py::quantize_for_inference.
//
// What bounds it on an H100: at the serving shapes (M = 1..32, K = 4096 or 6400,
// N = 4096) wq is 17-26 MB and every other operand is tiny, so the least time is
// reading wq once at 3.35 TB/s (5-8 us). At large M (the 1x1-convolution shapes of
// QuantizedConv1x1Layer) the float32 output and the int8 tensor-core rate bound it.
//
// Design:
// - Products on the int8 tensor cores, mma.sync m16n8k32 s8.s8.s32, computing y^T:
//   the weights are the A operand (MMA rows = output columns n) and the batch the
//   B operand (MMA columns = rows m of xq), so M <= 8 fills one n8 tile and xq's
//   rows, k-contiguous as stored, are B fragments as they stand (4-byte loads).
//   wgmma takes 8-bit operands only K-major from shared memory and ldmatrix.trans
//   moves 16-bit elements only, so neither reads wq's n-contiguous rows; mma.sync
//   with the transpose in registers keeps the contract layout without a copy.
// - A fragments from wq [K, N]: a warp owns 64 columns, four m16 tiles. The MMA
//   rows are mapped onto columns so that lane group g = lane / 4 owns the 8
//   neighbouring columns 8g .. 8g+7: row g of tile i is column 8g + i, row g + 8 is
//   column 8g + 4 + i. Lane (g, t = lane % 4) reads 8 bytes of each of the k rows
//   4t .. 4t+3 (and 16 + 4t ..), and two 4 x 4 byte transposes (transpose4x4,
//   __byte_perm) turn them into the 4 k-words of its 8 columns: every byte read
//   lands in a fragment. The accumulator then holds, per lane, 8 neighbouring
//   columns of batch rows 2t and 2t + 1.
// - Staging: a kStages-deep ring of K slices in shared memory, filled by 16-byte
//   cp.async copies (K and N multiples of 16, 16-byte aligned operands) or, for
//   ragged shapes, by masked byte loads; everything outside the problem stages 0.
//   Each group of 4 staged wq rows starts 32 bytes past the last (w_row), so a
//   half-warp's 8-byte fragment loads hit 32 distinct banks; xq rows are padded by
//   kXPad bytes for the same reason.
// - Warp roles: kProducerWarps warps only stage slices and 4 MMA warps only
//   multiply, handing the ring's slots over through mbarriers (cp.async.mbarrier
//   .arrive marks a slot full once its copies land; the MMA warps mark it empty).
//   When every warp did both, each slice cost its copies' issue (which the memory
//   system throttles) plus its MMAs, one after the other; now they overlap.
// - Tiles (kTiles): at M <= 32 a block owns 64 columns and the whole batch (one row
//   tile: each weight byte is read once), and its 4 MMA warps take alternate k32
//   steps of each slice; at larger M they tile 64 x 128 (or 128 x 64 where N <= 64).
// - Split K in one launch: where the tiles leave SMs idle (the serving shapes have
//   64), K is split in 32-row units over the ranks of a thread-block cluster of up
//   to kMaxRanks blocks; the split is a function of the shape and the SM count
//   only. The serving shapes take clusters of 2: an H100's GPCs hold every
//   2-block cluster of the grid one block an SM, but not 16 clusters of 8 (16
//   tiles of 256 columns), which left some SMs running two blocks. Each warp
//   group writes its int32
//   partial tile to shared memory and the block adds them; after cluster.sync()
//   rank r adds its share of the tile over the ranks' tiles through distributed
//   shared memory (integers: exact in any order) and runs the epilogue, with scale
//   and bias fetched before the main loop; a second cluster.sync() keeps every
//   rank's shared memory alive until it has been read. A rank with no rows adds
//   zeros. No workspace in device memory, no second kernel.
// - Exact sums: |acc| <= 128 * 128 * K < 2^31 for K < 131072 (the wrapper checks;
//   the s32 MMA accumulation would wrap silently past it).
// - Epilogue: int32 -> f32 with __int2float_rn, then __fmul_rn and __fadd_rn, so
//   scale and bias round twice as in the plain version and the JAX package (nvcc
//   would contract them into one FMA); then the activation of activations.cuh.

#include <cooperative_groups.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "activations.cuh"
#include "ffma_gemm.cuh"
#include "mma_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
namespace mma = dl4j::mma;
using dl4j::apply_act;
using dl4j::kNumActs;

constexpr int kWarpCols = 64;    // output columns a warp: four m16 tiles
constexpr int kWarpSteps = 2;    // k32 MMA steps a warp takes from each staged slice
constexpr int kStages = 4;       // slices in the shared-memory ring
constexpr int kXPad = 16;        // bytes past a slice's k in a staged xq row
constexpr int kUnit = 32;        // K rows a unit: ranks split K in whole units
constexpr int kMaxRanks = 8;     // cluster ranks splitting K, at most
constexpr int kMinRows = 256;    // K rows a rank, at least, once K is split
constexpr int kBlocksPerSm = 1;  // split K while the grid has fewer blocks an SM
constexpr int kProducerWarps = 4;  // warps that only stage slices
// (warps along N, warps along M, n8 tiles a warp, warps along K) of each tile
// config: the plan takes config 0, 1, 2 for M <= 8, 16, 32 (one row tile holds the
// batch: 64 columns, 4 warps sharing each slice's k), then 3, or 4 where N <= 64
constexpr int kTiles[5][4] = {
    {1, 1, 1, 4}, {1, 1, 2, 4}, {1, 1, 4, 4}, {2, 2, 4, 1}, {1, 4, 4, 1}};
constexpr int kNumConfigs = 5;

template <int CFG>
struct Tile {
  static constexpr int WN = kTiles[CFG][0], WM = kTiles[CFG][1];
  static constexpr int NT = kTiles[CFG][2], WK = kTiles[CFG][3];
  static constexpr int kMmaWarps = WN * WM * WK;
  static constexpr int kThreads = 32 * (kMmaWarps + kProducerWarps);
  static constexpr int BN = kWarpCols * WN;       // output columns a block
  static constexpr int BM = 8 * NT * WM;          // output rows a block
  static constexpr int BK = 32 * WK * kWarpSteps;  // k of a staged slice
  static constexpr int kXLd = BK + kXPad;         // staged xq row stride (bytes)
  static constexpr int kWBytes = BK * BN + 32 * (BK / 4);  // staged wq slice
  static constexpr int kStageBytes = kWBytes + BM * kXLd;
  static constexpr int kPartLd = BN + 4;          // int32 partial row stride
  static constexpr int kPartInts = BM * kPartLd;  // one warp group's partial tile
  static constexpr int kGroups = BM * BN / 4;     // 4-column groups of a tile
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPart = WK * kPartInts * 4;  // the warp groups' partials
  // the inbox, past the ring: R senders' int4 slots for a rank's share of the
  // groups, R * ceil(G / R) <= kGroups + kMaxRanks
  static constexpr int kInboxAt = kRing > kPart ? kRing : kPart;
  static constexpr int kSmem = kInboxAt + (kGroups + kMaxRanks) * 16;
};

// act(float(acc) * scale + bias), rounded twice; ACT >= 0 is that activation
// inlined, -1 the run-time switch on act
template <int ACT>
__device__ __forceinline__ float epilogue(int acc, float scale, float bias, int act) {
  return apply_act(ACT < 0 ? act : ACT,
                   __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias));
}

// Where row r of a staged wq slice starts: each group of 4 rows 32 bytes past the
// last, so the 4 rows 4t + j (t = 0..3) a half-warp's fragment loads read at one j
// lie in 4 different 32-byte bank windows; a row stays contiguous.
template <int BN>
__device__ __forceinline__ int w_row(int r) {
  return r * BN + 32 * (r >> 2);
}

// The 4 x 4 byte transpose: r[j] holds byte i of column i at row j; c[i] gets the
// four rows of column i (byte j = r[j] byte i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// mbarriers of the ring: a slot's "full" barrier completes when the producer
// warps' copies into it have landed, its "empty" one when every MMA warp is done
// with it
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mma::smem_addr(bar))
               : "memory");
}
// arrives on bar once every cp.async this thread has issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   mma::smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stages k in [k0, k0 + BK) of rows [m0, m0 + BM) of x and columns [n0, n0 + BN) of
// w into one ring slot; 0 at k >= kend and outside the problem. kVec: K, N and kend
// are multiples of 16 and x, w 16-byte aligned, so every 16-byte piece is wholly in
// or out (cp.async, zero-filled); otherwise byte by byte.
template <int CFG, bool kVec>
__device__ __forceinline__ void load_slice(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           unsigned char* slot, int M, int N, int K,
                                           int m0, int n0, int k0, int kend, int tid) {
  using C = Tile<CFG>;
  constexpr int kNT = 32 * kProducerWarps;  // tid: the producer thread
  unsigned char* ws = slot;
  unsigned char* xs = slot + C::kWBytes;
  if constexpr (kVec) {
#pragma unroll
    for (int p = tid; p < C::BK * (C::BN / 16); p += kNT) {
      const int r = p / (C::BN / 16), c = (p % (C::BN / 16)) * 16;
      const bool ok = k0 + r < kend && n0 + c < N;
      mma::cp_async16(ws + w_row<C::BN>(r) + c,
                      ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w, ok);
    }
#pragma unroll
    for (int p = tid; p < C::BM * (C::BK / 16); p += kNT) {
      const int r = p / (C::BK / 16), c = (p % (C::BK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < kend;
      mma::cp_async16(xs + r * C::kXLd + c,
                      ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, ok);
    }
  } else {
    for (int p = tid; p < C::BK * C::BN; p += kNT) {
      const int r = p / C::BN, c = p % C::BN;
      const bool ok = k0 + r < kend && n0 + c < N;
      ws[w_row<C::BN>(r) + c] = static_cast<unsigned char>(
          ok ? w[static_cast<size_t>(k0 + r) * N + n0 + c] : int8_t{0});
    }
    for (int p = tid; p < C::BM * C::BK; p += kNT) {
      const int r = p / C::BK, c = p % C::BK;
      const bool ok = m0 + r < M && k0 + c < kend;
      xs[r * C::kXLd + c] = static_cast<unsigned char>(
          ok ? x[static_cast<size_t>(m0 + r) * K + k0 + c] : int8_t{0});
    }
  }
}

// acc[i][q] += the warp's products over its k32 steps of one staged slice (steps
// wk, wk + WK, ...): m16 tile i (columns 8g + i and 8g + 4 + i of the warp's 64)
// by n8 tile q (rows 8q .. 8q + 7 of the warp's).
template <int CFG>
__device__ __forceinline__ void mma_slice(const unsigned char* __restrict__ slot,
                                          int (&acc)[4][Tile<CFG>::NT][4], int wn,
                                          int wm, int wk, int g, int t) {
  using C = Tile<CFG>;
  const unsigned char* ws = slot;
  const unsigned char* xs = slot + C::kWBytes;
  const int col = kWarpCols * wn + 8 * g;
#pragma unroll
  for (int kk = 32 * wk; kk < C::BK; kk += 32 * C::WK) {
    uint32_t a[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k 4t .. 4t+3, then 16 + 4t ..
      uint32_t lo[4], hi[4], cl[4], ch[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kk + 16 * h + 4 * t + j;
        const uint2 v = *reinterpret_cast<const uint2*>(ws + w_row<C::BN>(r) + col);
        lo[j] = v.x;  // columns 8g .. 8g+3
        hi[j] = v.y;  // columns 8g+4 .. 8g+7
      }
      transpose4x4(lo, cl);
      transpose4x4(hi, ch);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][2 * h] = cl[i];      // row g of tile i: column 8g + i
        a[i][2 * h + 1] = ch[i];  // row g + 8: column 8g + 4 + i
      }
    }
#pragma unroll
    for (int q = 0; q < C::NT; ++q) {
      const unsigned char* xr = xs + (8 * (C::NT * wm + q) + g) * C::kXLd + kk + 4 * t;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(xr),
                             *reinterpret_cast<const uint32_t*>(xr + 16)};
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[i][q], a[i], b);
    }
  }
}

// The owner's groups [gb, ge) of 4 columns: the ranks' sums from the inbox (slot
// [sender][group - gb]) added in rank order, then the epilogue with the block's
// staged scale and bias, stored to y.
template <int ACT, int CFG>
__device__ __forceinline__ void store_groups(const int4* inbox,
                                             const float (*sb)[Tile<CFG>::BN],
                                             float* __restrict__ y, int N, int m0,
                                             int n0, int gb, int ge, int share,
                                             int ranks, int act, int tid) {
  using C = Tile<CFG>;
  const bool vec_out = N % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  for (int gi = gb + tid; gi < ge; gi += C::kThreads) {
    const int r = gi / (C::BN / 4), c = (gi % (C::BN / 4)) * 4;
    const int n = n0 + c;
    if (n >= N) continue;
    int sum[4] = {0, 0, 0, 0};
    for (int rr = 0; rr < ranks; ++rr) {
      const int4 v = inbox[rr * share + gi - gb];
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    float z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = epilogue<ACT>(sum[j], sb[0][c + j], sb[1][c + j], act);
    float* out = y + static_cast<size_t>(m0 + r) * N + n;
    if (vec_out) {  // n + 3 < N: N and n are multiples of 4
      *reinterpret_cast<float4*>(out) = make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n + j < N) out[j] = z[j];
      }
    }
  }
}

// Cluster (R, 1, 1) of blocks (blockIdx.x = R * row tile + rank, blockIdx.y = column
// tile): rank r sums the K units [r U / R, (r+1) U / R) of the block's tile.
template <int CFG, bool kVec>
__global__ void __launch_bounds__(Tile<CFG>::kThreads, 1)
    mma_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ b,
                    float* __restrict__ y, int M, int N, int K, int act) {
  using C = Tile<CFG>;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  cg::cluster_group cluster = cg::this_cluster();
  // arrive now, wait before the first store to another rank: every rank has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp % C::WN, wm = warp / C::WN % C::WM, wk = warp / (C::WN * C::WM);
  const int m0 = static_cast<int>(blockIdx.x / ranks) * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const long long units = (static_cast<long long>(K) + kUnit - 1) / kUnit;
  const int kb = kUnit * static_cast<int>(rank * units / ranks);
  const int ke = min(K, kUnit * static_cast<int>((rank + 1) * units / ranks));
  const int nk = ke > kb ? (ke - kb + C::BK - 1) / C::BK : 0;

  // this block's columns' scale and bias, staged for the epilogue while the main
  // loop runs (the first barrier below makes them visible)
  __shared__ float sb[2][C::BN];
  for (int c = tid; c < C::BN; c += C::kThreads) {
    sb[0][c] = n0 + c < N ? scale[n0 + c] : 0.f;
    sb[1][c] = n0 + c < N ? b[n0 + c] : 0.f;
  }

  int acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0;
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32 * kProducerWarps);
      mbar_init(&empty[s], C::kMmaWarps);
    }
  }
  __syncthreads();

  // The producer warps stage slice s into slot s % kStages once the MMA warps have
  // released the slot's previous slice; the MMA warps take each slice as it lands.
  // Neither waits for the other's work: the copies of the next slices are in flight
  // while this one is multiplied.
  if (warp >= C::kMmaWarps) {
    for (int s = 0; s < nk; ++s) {
      const int slot = s % kStages;
      if (s >= kStages) mbar_wait(&empty[slot], (s / kStages - 1) & 1);
      load_slice<CFG, kVec>(x, w, smem + slot * C::kStageBytes, M, N, K, m0, n0,
                            kb + s * C::BK, ke, tid - 32 * C::kMmaWarps);
      if constexpr (kVec) {
        mbar_arrive_cp_async(&full[slot]);
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    mma::cp_async_wait<0>();
  } else {
    for (int s = 0; s < nk; ++s) {
      const int slot = s % kStages;
      mbar_wait(&full[slot], (s / kStages) & 1);
      mma_slice<CFG>(smem + slot * C::kStageBytes, acc, wn, wm, wk, g, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();  // the ring is free: it becomes the warp groups' partial tiles

  // the partial tiles [WK][BM][kPartLd] int32, one a warp group: lane (g, t) holds
  // rows 2t, 2t + 1 of each n8 tile and the 8 columns 8g .. 8g+7 of its warp's 64
  int* part = reinterpret_cast<int*>(smem);
  if (warp < C::kMmaWarps) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int* dst = part + wk * C::kPartInts +
                   (8 * (NT * wm + q) + 2 * t + e) * C::kPartLd + kWarpCols * wn + 8 * g;
        *reinterpret_cast<int4*>(dst) =
            make_int4(acc[0][q][e], acc[1][q][e], acc[2][q][e], acc[3][q][e]);
        *reinterpret_cast<int4*>(dst + 4) =
            make_int4(acc[0][q][2 + e], acc[1][q][2 + e], acc[2][q][2 + e], acc[3][q][2 + e]);
      }
    }
  }
  __syncthreads();

  // Rank o owns the tile's 4-column groups [o G / R, (o+1) G / R) of its valid rows.
  // Every rank adds its warp groups' partials per group and stores the sum in the
  // owner's inbox (distributed shared memory past the ring, so a rank still in its
  // main loop is not disturbed), slot [sender rank][group - first]; after one
  // cluster.sync() each owner adds its inbox in rank order and runs the epilogue.
  // Remote stores only: no rank touches another's memory after that barrier.
  const int rows = min(C::BM, M - m0);
  const int groups = rows * (C::BN / 4);
  const int share = (groups + ranks - 1) / ranks;  // inbox slots a sender
  int4* inbox = reinterpret_cast<int4*>(smem + C::kInboxAt);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int gi = tid; gi < groups; gi += C::kThreads) {
    const int* src = part + (gi / (C::BN / 4)) * C::kPartLd + (gi % (C::BN / 4)) * 4;
    int4 v[C::WK];
#pragma unroll
    for (int k = 0; k < C::WK; ++k) v[k] = *reinterpret_cast<const int4*>(src + k * C::kPartInts);
#pragma unroll
    for (int k = 1; k < C::WK; ++k) {
      v[0] = make_int4(v[0].x + v[k].x, v[0].y + v[k].y, v[0].z + v[k].z, v[0].w + v[k].w);
    }
    const int owner = static_cast<int>((static_cast<long long>(gi) * ranks + ranks - 1) / groups);
    const int first = static_cast<int>(static_cast<long long>(owner) * groups / ranks);
    *(cluster.map_shared_rank(inbox, owner) + rank * share + gi - first) = v[0];
  }
  cluster.sync();

  const int gb = static_cast<int>(static_cast<long long>(rank) * groups / ranks);
  const int ge = static_cast<int>(static_cast<long long>(rank + 1) * groups / ranks);
  // identity and relu (the serving layers' activations) inlined, any other through
  // the run-time switch: the switch inlined at each output costs every call its
  // instruction fetch at the kernel's end
  switch (act) {
    case 0:
      store_groups<0, CFG>(inbox, sb, y, N, m0, n0, gb, ge, share, ranks, act, tid);
      break;
    case 3:
      store_groups<3, CFG>(inbox, sb, y, N, m0, n0, gb, ge, share, ranks, act, tid);
      break;
    default:
      store_groups<-1, CFG>(inbox, sb, y, N, m0, n0, gb, ge, share, ranks, act, tid);
  }
}

int tile_config(int m, int n) {
  return m <= 8 ? 0 : m <= 16 ? 1 : m <= 32 ? 2 : n > kWarpCols ? 3 : 4;
}

int block_rows(int cfg) { return 8 * kTiles[cfg][2] * kTiles[cfg][1]; }
int block_cols(int cfg) { return kWarpCols * kTiles[cfg][0]; }

// The cluster ranks of an (m, n, k) problem: doubled up to kMaxRanks while the
// grid stays within kBlocksPerSm blocks an SM and every rank keeps kMinRows rows.
int cluster_ranks(int cfg, int m, int n, int k, int num_sms) {
  const long long tiles = static_cast<long long>((m + block_rows(cfg) - 1) / block_rows(cfg)) *
                          ((n + block_cols(cfg) - 1) / block_cols(cfg));
  const long long units = (static_cast<long long>(k) + kUnit - 1) / kUnit;
  int ranks = 1;
  while (ranks < kMaxRanks &&
         tiles * 2 * ranks <= static_cast<long long>(kBlocksPerSm) * num_sms &&
         units >= 2LL * ranks * (kMinRows / kUnit)) {
    ranks *= 2;
  }
  return ranks;
}

template <int CFG, bool kVec>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale, const float* b,
                   float* y, int m, int n, int k, int act, int ranks, int device,
                   cudaStream_t stream) {
  using C = Tile<CFG>;
  auto* const kernel = mma_int8_kernel<CFG, kVec>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = mma::allow_smem(kernel, C::kSmem, device, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((m + C::BM - 1) / C::BM * ranks),
                        static_cast<unsigned>((n + C::BN - 1) / C::BN), 1);
  config.blockDim = dim3(C::kThreads, 1, 1);
  config.dynamicSmemBytes = C::kSmem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, x, w, scale, b, y, m, n, k, act);
}

template <int CFG>
cudaError_t dispatch_vec(bool vec, const int8_t* x, const int8_t* w, const float* scale,
                         const float* b, float* y, int m, int n, int k, int act,
                         int ranks, int device, cudaStream_t s) {
  return vec ? launch<CFG, true>(x, w, scale, b, y, m, n, k, act, ranks, device, s)
             : launch<CFG, false>(x, w, scale, b, y, m, n, k, act, ranks, device, s);
}

}  // namespace

extern "C" {

// The launch plan of an (m, n, k) problem on `device` (m, n >= 1, k >= 0): the tile
// config times 16 plus the cluster ranks splitting K. A function of the shape and
// the card's SM count; the caller keeps it per shape. A negative value is a negated
// cudaError_t.
int dl4j_matmul_int8_plan(int m, int n, int k, int device) {
  if (m <= 0 || n <= 0 || k < 0) return -static_cast<int>(cudaErrorInvalidValue);
  int num_sms = 0;
  const cudaError_t err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int cfg = tile_config(m, n);
  const int ranks = cluster_ranks(cfg, m, n, k, num_sms);
  if ((n + block_cols(cfg) - 1) / block_cols(cfg) > 65535 ||
      static_cast<long long>((m + block_rows(cfg) - 1) / block_rows(cfg)) * ranks > INT_MAX) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return cfg * 16 + ranks;
}

// x [m, k] int8, w [k, n] int8, scale and b [n] float32, y [m, n] float32; plan:
// a tile config times 16 plus the cluster ranks (dl4j_matmul_int8_plan's value for
// (m, n, k), or another config and power-of-two ranks up to kMaxRanks: the
// registry's tuned tiling), or 0 for dl4j_matmul_int8_plan's rule; act: an id of
// apply_act. The sums are exact integers under every plan, so every plan gives
// the same bits. Returns a cudaError_t (0 = launched); the launch is
// asynchronous on `stream`.
int dl4j_matmul_bias_act_int8(const void* x, const void* w, const void* scale,
                              const void* b, void* y, int m, int n, int k, int act,
                              int plan, int device, void* stream) {
  if (plan == 0 && m > 0 && n > 0 && k >= 0) {
    plan = dl4j_matmul_int8_plan(m, n, k, device);
    if (plan < 0) return -plan;
  } else if (plan == 0) {
    plan = 1;  // nothing to launch: any legal plan
  }
  const int cfg = plan / 16, ranks = plan % 16;
  if (m < 0 || n < 0 || k < 0 || act < 0 || act >= kNumActs || cfg < 0 ||
      cfg >= kNumConfigs || (ranks & (ranks - 1)) != 0 || ranks < 1 || ranks > kMaxRanks ||
      (n + block_cols(cfg) - 1) / block_cols(cfg) > 65535 ||
      static_cast<long long>((m + block_rows(cfg) - 1) / block_rows(cfg)) * ranks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const bool vec = k % 16 == 0 && n % 16 == 0 && dl4j::aligned16(x) && dl4j::aligned16(w);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0:
      err = dispatch_vec<0>(vec, xp, wp, sp, bp, yp, m, n, k, act, ranks, device, s);
      break;
    case 1:
      err = dispatch_vec<1>(vec, xp, wp, sp, bp, yp, m, n, k, act, ranks, device, s);
      break;
    case 2:
      err = dispatch_vec<2>(vec, xp, wp, sp, bp, yp, m, n, k, act, ranks, device, s);
      break;
    case 3:
      err = dispatch_vec<3>(vec, xp, wp, sp, bp, yp, m, n, k, act, ranks, device, s);
      break;
    default:
      err = dispatch_vec<4>(vec, xp, wp, sp, bp, yp, m, n, k, act, ranks, device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
