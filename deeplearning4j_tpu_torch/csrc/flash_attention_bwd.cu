// Flash attention backward for Hopper: dq, dk and dv of
// o = softmax(scale * q . k^T, masked) . v over [B, H, T, D] operands, from the
// forward's o and row statistics l (sum of exp) and m (row max), and the
// cotangent do.
//
// Replaces the Pallas kernels deeplearning4j_tpu/ops/attention.py::_dq_kernel and
// ::_dkv_kernel (_flash_bwd_impl, the custom VJP of flash_attention). Both
// recompute p = exp(s - m) / l from the scores (l == 0 divides by 1),
// di = rowsum(do . o) in f32 from the stored o, dp = do . v^T and
// ds = p (dp - di) * scale; _dq_kernel sums dq = ds . k over the key blocks of
// the TPU grid's sequential dimension, _dkv_kernel dk = ds^T . q and
// dv = p^T . do over the query blocks, each into VMEM scratch.
//
// What bounds it on an H100: at [8, 12, 1024, 64] causal the dq kernel does 3
// products of 2 B H T^2 D / 2 operations (s, dp, dq) and the dk/dv kernel 4 (s,
// dp, dv, dk) on 9 and 7 [B, H, T, D] operands: about T / 10 operations a byte in
// float32, so operations bound both. f32 stays f32: the products run on the
// tensor cores through the 3xTF32 split (three TF32 MMAs a product, f32
// accuracy: 495 / 3 = 165 TFLOP/s, against 67 for FFMA); bf16 runs bf16 MMAs.
//
// Design: the TPU's split into two kernels is kept. dq is owned by query rows
// and dk, dv by key rows, so no sum crosses blocks: no atomics, and the result is
// the same from run to run. For DP = 32, 64 and 128 (D padded up to them):
// - dq kernel: a block of 4 warps owns 64 query rows of one (b, h), 16 a warp.
//   Q and dO stay in shared memory; a loop over key tiles of BN rows (32, or 16
//   at DP = 128) up to the causal limit of the block's last row computes per
//   warp S = Q . K^T, P in registers, dP = dO . V^T, dS in registers and
//   dQ += dS . K (mma.sync m16n8k8 tf32 x 3 for f32, m16n8k16 bf16). di is
//   computed once per row from dO and o and written as the [B, H, Tq] f32
//   by-product.
// - dk/dv kernel: a block owns 64 key rows, K and V in shared memory; a loop
//   over query tiles from the first one at or below the diagonal stages Q, dO and
//   the tile's m, 1 / l, di and key limit, and computes S^T = K . Q^T, P^T,
//   dV += P^T . dO, dP^T = V . dO^T, dS^T and dK += dS^T . Q. It reads di from
//   the dq kernel, which runs before it on the same stream: o is never read here.
// What the design does about the limits of the first, FFMA-only version (kept
// below for DP = 256 and 512):
// 1. FFMA only: every product is a tensor-core MMA (mma_tiles.cuh).
// 2. Matrix-vector structure: a warp's m16n8 tiles reuse each shared value 8 or
//    16 times; accumulators for 16 rows x DP columns stay in registers.
// 3. Serial dot-product chains: the MMAs of a tile are independent.
// 4. Synchronous staging: K/V (dq) and Q/dO (dk/dv) tiles come by 16-byte
//    cp.async into a 2-stage ring, the next tile in flight while the current one
//    is split and computed; rows past Tq or Tk are zero-filled by the copy (a
//    garbage row times p = 0 could still be NaN). The tiles take 86 KB (f32,
//    DP = 64: two blocks an SM) of dynamic shared memory, allowed per kernel
//    variant and device with cudaFuncSetAttribute.
// 5. Per-element masking: only tiles that cross the causal diagonal, the ragged
//    edge of Tq or Tk, or carry a key mask take the masked path; full tiles
//    compute p = exp(s * scale - m) / l with no branch.
// 6. Tail imbalance: the dq grid maps its tile index in reverse, and both grids
//    put the tile index in the slow dimension, so the longest causal rows (dq)
//    and key columns (dk/dv) of every head start first.
// What holds the f32 products near f32 accuracy at the tensor cores' rate:
// - The split costs ALU work per element, and each staged tile feeds 4 warps:
//   the B tiles (K, V in dq; Q, dO in dk/dv) are split once in shared memory
//   (big in place, small beside it), the A operands in registers where they
//   are used. cvt.rna.tf32 is computed with two integer operations
//   (mma_tiles.cuh): on an H100 the instruction made both kernels 1.4-1.6x
//   slower at the main shape.
// - The tensor cores round each accumulation toward zero, so a sum over 1024
//   keys or queries in one accumulator drifts by ~1e-5 of its size; dQ, dK and
//   dV sum each tile's products from zero and add them to their f32 totals
//   (kFresh), which brings the kernels within ~1e-5 of float64 at 8 x 1024.
// P and dS feed the next product from the accumulator registers: bf16 packs two
// neighbouring n-tiles into one A fragment, tf32 permutes the k order of the
// product (mma_tiles.cuh). wgmma is not used: for tf32 it takes K-major
// operands on both sides, so dS . K and P^T . dO would need transposed copies of
// K and dO in shared memory; it is the step for a bf16 compute policy.
// For DP = 256 and 512 the accumulators of 16 rows x DP do not fit a warp's
// registers, so the dispatch chooses the FFMA kernels by head size before
// launch (never after a failure); their redesign is open work.
//
// Rules shared with the forward (flash_common.cuh): masked scores are SET to
// -1e30 (keys past Tk weigh 0); the scale multiplies each f32 dot product after
// it is formed and ds after p (dp - di); ragged Tq and Tk are masked, not padded,
// and queries past Tq contribute nothing to dk and dv. In bf16, p is rounded to
// bf16 before p^T . do and ds before ds . k and ds^T . q, where _dq_kernel and
// _dkv_kernel cast them; products accumulate in f32.
//
// Rows with no valid key (a length-0 feature mask): every score is -1e30, so
// m = -1e30 and p = 1 / l at each key the forward visited (l counts them), and ds
// is not 0. Both kernels weigh exactly the keys the forward visited for the row
// (flash_key_limit, on the forward's tiles) and no others, so every gradient
// stays finite; it is the JAX package's rule, not a true gradient, and such rows
// are not compared.

#include <atomic>
#include <cstdint>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using dl4j::round_like;
using dl4j::Strides;
namespace mma = dl4j::mma;

// ---------------------------------------------------------------------------
// tensor-core kernels, DP = 32, 64, 128
// ---------------------------------------------------------------------------

// A block of NT threads (4 warps) owns BM rows, 16 a warp, and walks the other
// operand in tiles of BN rows; shared tiles have row stride LD (mma_tiles.cuh).
// A warp's S and dP accumulators (16 x BN each) sit beside its 16 x DP ones
// (dq; dk and dv) in registers. Shared memory: two BM tiles, a 2-stage ring of
// two BN tiles, in f32 the small halves of the current BN tiles (split_tile),
// and f32 / int vectors (dq: the key mask of each stage and di; dk/dv: m, 1 / l,
// di and the key limit of each stage). In f32 at DP <= 64 the products that sum
// over the loop (dQ, dK, dV) start each tile from zero (mma_ckn's kFresh); at
// DP = 128 their two 16 x 128 accumulators leave no registers for it.
template <typename T, int DP>
struct MmaCfg {
  static constexpr int NT = 128, BM = 64;
  static constexpr int BN = DP <= 64 ? 32 : 16;
  static constexpr int LD = mma::tile_ld<T>(DP);
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr bool kFresh = kSplit && DP <= 64;
  static constexpr int kSmem =
      (2 * BM + (kSplit ? 6 : 4) * BN) * LD * static_cast<int>(sizeof(T)) +
      (8 * BN + BM) * 4;
};

// a row's m, 1 / l and key limit (rows past Tq: 0, 1, 0)
struct RowStats {
  float m, linv;
  int lim;
};

template <int DP>
__device__ __forceinline__ RowStats row_stats(const float* __restrict__ m,
                                              const float* __restrict__ l,
                                              long long base, int row, int Tq,
                                              int Tk, int causal) {
  if (row >= Tq) return {0.f, 1.f, 0};
  const float lv = l[base + row];
  return {m[base + row], lv == 0.f ? 1.f : 1.f / lv,
          dl4j::flash_key_limit<DP>(row, Tq, Tk, causal)};
}

template <typename T, int DP>
__global__ void __launch_bounds__(MmaCfg<T, DP>::NT)
    mma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ key_mask,
                  const T* __restrict__ dout, const T* __restrict__ o,
                  const float* __restrict__ l, const float* __restrict__ m,
                  T* __restrict__ dq, float* __restrict__ di_out, int H, int Tq,
                  int Tk, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                  int causal, float scale, int vec) {
  using C = MmaCfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NT = C::NT;
  constexpr int NK = BN / 8;  // n-tiles of S and dP
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BM * LD;
  T* ks = dos + BM * LD;        // [2][BN][LD]
  T* vs = ks + 2 * BN * LD;     // [2][BN][LD]
  T* ksm = vs + 2 * BN * LD;    // [BN][LD], f32 only: the small halves
  T* vsm = ksm + BN * LD;       // [BN][LD]
  float* mask_s = reinterpret_cast<float*>(
      C::kSplit ? vsm + BN * LD : ksm);  // [2][BN]
  float* di_s = mask_s + 2 * BN;         // [BM]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // the last query tile (the longest causal rows) first
  const int row0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int kend = dl4j::flash_key_limit<DP>(min(row0 + BM - 1, Tq - 1), Tq, Tk,
                                             causal);
  const int ntiles = (kend + BN - 1) / BN;

  mma::load_tile<T, BM, DP, LD, NT>(qs, q + b * sq.b + h * sq.h, sq.t, row0, Tq,
                                    D, vec, tid);
  mma::load_tile<T, BM, DP, LD, NT>(dos, dout + b * sdo.b + h * sdo.h, sdo.t,
                                    row0, Tq, D, vec, tid);
  mma::cp_async_commit();
  if (ntiles > 0) {
    mma::load_tile<T, BN, DP, LD, NT>(ks, kb, sk.t, 0, Tk, D, vec, tid);
    mma::load_tile<T, BN, DP, LD, NT>(vs, vb, sv.t, 0, Tk, D, vec, tid);
  }
  mma::cp_async_commit();
  if (key_mask != nullptr && tid < BN) {
    mask_s[tid] = tid < Tk ? key_mask[static_cast<long long>(b) * Tk + tid] : 1.f;
  }
  const int ra = row0 + warp * 16 + g;  // the thread's rows ra and ra + 8
  const RowStats sa = row_stats<DP>(m, l, bh * Tq, ra, Tq, Tk, causal);
  const RowStats sb = row_stats<DP>(m, l, bh * Tq, ra + 8, Tq, Tk, causal);
  mma::cp_async_wait<1>();  // Q and dO
  __syncthreads();

  {  // di = rowsum(do . o) in f32: two threads a row, half of DP each
    const int rr = tid >> 1, row = row0 + rr;
    const int d0 = (tid & 1) * (DP / 2), d1 = min(D, d0 + DP / 2);
    float part = 0.f;
    if (row < Tq) {
      const T* orow = o + (bh * Tq + row) * D;
      const T* drow = dos + rr * LD;
      for (int d = d0; d < d1; ++d) {
        part = fmaf(dl4j::to_f32(drow[d]), dl4j::to_f32(orow[d]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      di_s[rr] = part;
      if (row < Tq) di_out[bh * Tq + row] = part;
    }
  }

  float acc[DP / 8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = it * BN;
    const bool more = it + 1 < ntiles;
    mma::cp_async_wait<0>();  // this tile's K and V
    __syncthreads();          // ... visible; every warp is done with the last
    if (more) {
      const int nx = (st ^ 1) * BN * LD;
      mma::load_tile<T, BN, DP, LD, NT>(ks + nx, kb, sk.t, k0 + BN, Tk, D, vec,
                                        tid);
      mma::load_tile<T, BN, DP, LD, NT>(vs + nx, vb, sv.t, k0 + BN, Tk, D, vec,
                                        tid);
      mma::cp_async_commit();
    }
    float mask_next = 1.f;
    if (key_mask != nullptr && more && tid < BN && k0 + BN + tid < Tk) {
      mask_next = key_mask[static_cast<long long>(b) * Tk + k0 + BN + tid];
    }
    T* kt = ks + st * BN * LD;
    T* vt = vs + st * BN * LD;
    if constexpr (C::kSplit) {
      mma::split_tile<BN, DP, LD, NT>(kt, ksm, tid);
      mma::split_tile<BN, DP, LD, NT>(vt, vsm, tid);
      __syncthreads();
    }

    float s[NK][4] = {};
    mma::mma_abt<T, DP, NK, LD, LD>(s, qs + warp * 16 * LD, kt, ksm, lane);
    float dp[NK][4] = {};
    mma::mma_abt<T, DP, NK, LD, LD>(dp, dos + warp * 16 * LD, vt, vsm, lane);
    const float di_a = di_s[warp * 16 + g], di_b = di_s[warp * 16 + g + 8];
    if (key_mask == nullptr && k0 + BN <= Tk &&
        (!causal || k0 + BN - 1 <= row0 + off)) {
      // every key of the tile is visible to every row of the block
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const RowStats& r = e < 2 ? sa : sb;
          const float p = expf(s[j][e] * scale - r.m) * r.linv;
          s[j][e] = p * (dp[j][e] - (e < 2 ? di_a : di_b)) * scale;
        }
      }
    } else {
      const float* ms = mask_s + st * BN;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const RowStats& r = e < 2 ? sa : sb;
          const int row = ra + (e < 2 ? 0 : 8);
          const int c = j * 8 + 2 * t + (e & 1), col = k0 + c;
          float p = 0.f;
          if (col < r.lim) {
            p = expf(dl4j::masked_score(s[j][e], scale, row, col, Tk, off,
                                        causal,
                                        key_mask != nullptr ? ms[c] : 1.f) -
                     r.m) * r.linv;
          }
          s[j][e] = p * (dp[j][e] - (e < 2 ? di_a : di_b)) * scale;
        }
      }
    }
    mma::mma_ckn<T, NK, DP / 8, LD, C::kFresh>(acc, s, kt, ksm, lane);  // dQ
    if (key_mask != nullptr && more && tid < BN) {
      mask_s[(st ^ 1) * BN + tid] = mask_next;
    }
  }
  mma::store_acc<T, DP / 8>(dq + bh * Tq * D, acc, ra, Tq, D, t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(MmaCfg<T, DP>::NT)
    mma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ key_mask,
                   const T* __restrict__ dout, const float* __restrict__ l,
                   const float* __restrict__ m, const float* __restrict__ di,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                   int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                   int causal, float scale, int vec) {
  using C = MmaCfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NT = C::NT;
  constexpr int NQ = BN / 8;  // n-tiles of S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BM * LD;
  T* qs = vs + BM * LD;       // [2][BN][LD]
  T* dos = qs + 2 * BN * LD;  // [2][BN][LD]
  T* qsm = dos + 2 * BN * LD;  // [BN][LD], f32 only: the small halves
  T* dosm = qsm + BN * LD;     // [BN][LD]
  float* m_s = reinterpret_cast<float*>(
      C::kSplit ? dosm + BN * LD : qsm);  // [2][BN] each
  float* li_s = m_s + 2 * BN;
  float* di_s = li_s + 2 * BN;
  int* lim_s = reinterpret_cast<int*>(di_s + 2 * BN);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int col0 = static_cast<int>(blockIdx.y) * BM;  // key tile 0 is the longest
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* db = dout + b * sdo.b + h * sdo.h;

  // the first query tile with a row whose forward visited key col0 (a row's
  // key limit grows with the row)
  const int nq = (Tq + BN - 1) / BN;
  int i0 = 0;
  while (causal && i0 < nq &&
         dl4j::flash_key_limit<DP>(min(i0 * BN + BN - 1, Tq - 1), Tq, Tk,
                                   causal) <= col0) {
    ++i0;
  }
  mma::load_tile<T, BM, DP, LD, NT>(ks, k + b * sk.b + h * sk.h, sk.t, col0, Tk,
                                    D, vec, tid);
  mma::load_tile<T, BM, DP, LD, NT>(vs, v + b * sv.b + h * sv.h, sv.t, col0, Tk,
                                    D, vec, tid);
  if (i0 < nq) {
    mma::load_tile<T, BN, DP, LD, NT>(qs, qb, sq.t, i0 * BN, Tq, D, vec, tid);
    mma::load_tile<T, BN, DP, LD, NT>(dos, db, sdo.t, i0 * BN, Tq, D, vec, tid);
  }
  mma::cp_async_commit();
  if (tid < BN && i0 < nq) {
    const int row = i0 * BN + tid;
    const RowStats r = row_stats<DP>(m, l, bh * Tq, row, Tq, Tk, causal);
    m_s[tid] = r.m;
    li_s[tid] = r.linv;
    lim_s[tid] = r.lim;
    di_s[tid] = row < Tq ? di[bh * Tq + row] : 0.f;
  }
  const int ka = col0 + warp * 16 + g;  // the thread's key rows ka and ka + 8
  const float kmask_a = (key_mask != nullptr && ka < Tk)
                            ? key_mask[static_cast<long long>(b) * Tk + ka]
                            : 1.f;
  const float kmask_b = (key_mask != nullptr && ka + 8 < Tk)
                            ? key_mask[static_cast<long long>(b) * Tk + ka + 8]
                            : 1.f;
  const bool key_full = key_mask == nullptr && col0 + BM <= Tk;

  float dka[DP / 8][4] = {}, dva[DP / 8][4] = {};
  for (int it = i0; it < nq; ++it) {
    const int st = (it - i0) & 1, r0 = it * BN;
    const bool more = it + 1 < nq;
    mma::cp_async_wait<0>();  // this tile's Q and dO (and K, V)
    __syncthreads();          // ... visible; every warp is done with the last
    if (more) {
      const int nx = (st ^ 1) * BN * LD;
      mma::load_tile<T, BN, DP, LD, NT>(qs + nx, qb, sq.t, r0 + BN, Tq, D, vec,
                                        tid);
      mma::load_tile<T, BN, DP, LD, NT>(dos + nx, db, sdo.t, r0 + BN, Tq, D, vec,
                                        tid);
      mma::cp_async_commit();
    }
    RowStats next{0.f, 1.f, 0};
    float di_next = 0.f;
    if (more && tid < BN) {
      const int row = r0 + BN + tid;
      next = row_stats<DP>(m, l, bh * Tq, row, Tq, Tk, causal);
      di_next = row < Tq ? di[bh * Tq + row] : 0.f;
    }
    T* qt = qs + st * BN * LD;
    T* dt = dos + st * BN * LD;
    if constexpr (C::kSplit) {
      mma::split_tile<BN, DP, LD, NT>(qt, qsm, tid);
      mma::split_tile<BN, DP, LD, NT>(dt, dosm, tid);
      __syncthreads();
    }
    const float* ms = m_s + st * BN;
    const float* ls = li_s + st * BN;
    const float* dis = di_s + st * BN;
    const int* lims = lim_s + st * BN;

    float s[NQ][4] = {};
    mma::mma_abt<T, DP, NQ, LD, LD>(s, ks + warp * 16 * LD, qt, qsm, lane);  // S^T
    if (key_full && r0 + BN <= Tq && (!causal || col0 + BM - 1 <= r0 + off)) {
      // every key of the block is visible to every row of the tile
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 mm = *reinterpret_cast<const float2*>(ms + j * 8 + 2 * t);
        const float2 li = *reinterpret_cast<const float2*>(ls + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] * scale - ((e & 1) ? mm.y : mm.x)) *
                    ((e & 1) ? li.y : li.x);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1), row = r0 + c;
          const int key = ka + (e < 2 ? 0 : 8);
          float p = 0.f;  // rows past Tq have limit 0
          if (key < lims[c]) {
            p = expf(dl4j::masked_score(s[j][e], scale, row, key, Tk, off,
                                        causal, e < 2 ? kmask_a : kmask_b) -
                     ms[c]) * ls[c];
          }
          s[j][e] = p;
        }
      }
    }
    mma::mma_ckn<T, NQ, DP / 8, LD, C::kFresh>(dva, s, dt, dosm, lane);  // dV
    float dp[NQ][4] = {};
    mma::mma_abt<T, DP, NQ, LD, LD>(dp, vs + warp * 16 * LD, dt, dosm, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(dis + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dd.y : dd.x)) * scale;
      }
    }
    mma::mma_ckn<T, NQ, DP / 8, LD, C::kFresh>(dka, s, qt, qsm, lane);  // dK
    if (more && tid < BN) {
      const int nx = (st ^ 1) * BN + tid;
      m_s[nx] = next.m;
      li_s[nx] = next.linv;
      lim_s[nx] = next.lim;
      di_s[nx] = di_next;
    }
  }
  mma::cp_async_wait<0>();  // K and V, when no query tile reached the block
  mma::store_acc<T, DP / 8>(dk + bh * Tk * D, dka, ka, Tk, D, t);
  mma::store_acc<T, DP / 8>(dv + bh * Tk * D, dva, ka, Tk, D, t);
}

// ---------------------------------------------------------------------------
// FFMA kernels, DP = 256 and 512: TPR lanes own a row (a matrix-vector design)
// ---------------------------------------------------------------------------

// Backward tiles by padded head size DP: TPR lanes a row, 16 values of a row a
// lane (4 float4 chunks: chunk c of lane sl holds d = 4 (sl + TPR c) + e, so the
// TPR lanes of a row read distinct banks), NT threads a block owning S rows, and
// staged tiles of S rows.
template <int DP>
struct BwdCfg {
  static constexpr int TPR = DP / 16;
  static constexpr int NT = 256;
  static constexpr int S = NT / TPR;  // = 4096 / DP
};

template <int TPR, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, bool ok,
                                         int sl, int D, float (&r)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      r[c * 4 + e] = (ok && d < D) ? dl4j::to_f32(src[d]) : 0.f;
    }
  }
}

template <int TPR, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dst, bool ok, int sl,
                                          int D, const float (&r)[16]) {
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      if (d < D) dst[d] = dl4j::from_f32<T>(r[c * 4 + e]);
    }
  }
}

// a lane's 16 values of one staged f32 row
template <int TPR>
__device__ __forceinline__ void chunk(const float* __restrict__ row, int sl,
                                      float (&r)[16]) {
  const float4* t = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 x = t[sl + TPR * c];
    r[c * 4 + 0] = x.x;
    r[c * 4 + 1] = x.y;
    r[c * 4 + 2] = x.z;
    r[c * 4 + 3] = x.w;
  }
}

// the row's dot product: the lanes' partial sums, xor-shuffled across the TPR
// lanes of the row
template <int TPR>
__device__ __forceinline__ float dot(const float (&a)[16], const float (&b)[16]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) part = fmaf(a[i], b[i], part);
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, w);
  }
  return part;
}

__device__ __forceinline__ void axpy(float a, const float (&x)[16],
                                     float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = fmaf(a, x[i], acc[i]);
}

// rows [r0, r0 + S) of one [T, D] operand (row stride st) into shared memory as
// f32, zeros past n rows and past D
template <int DP, int S, int NT, typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, long long st,
                                      int r0, int n, int D, int tid) {
  for (int i = tid; i < S * DP; i += NT) {
    const int j = i / DP, d = i % DP;
    const int r = r0 + j;
    dst[i] = (r < n && d < D) ? dl4j::to_f32(src[static_cast<long long>(r) * st + d])
                              : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<DP>::NT)
    ffma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_mask,
                    const T* __restrict__ dout, const T* __restrict__ o,
                    const float* __restrict__ l, const float* __restrict__ m,
                    T* __restrict__ dq, float* __restrict__ di_out, int H, int Tq,
                    int Tk, int D, Strides sq, Strides sk, Strides sv,
                    Strides sdo, int causal, float scale) {
  constexpr int TPR = BwdCfg<DP>::TPR;
  constexpr int S = BwdCfg<DP>::S;
  constexpr int NT = BwdCfg<DP>::NT;
  __shared__ __align__(16) float ks[S * DP];
  __shared__ __align__(16) float vs[S * DP];
  __shared__ float mask_s[S];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int row0 = static_cast<int>(blockIdx.x) * S;
  const int row = row0 + tid / TPR;
  const bool live = row < Tq;
  const int off = Tk - Tq;
  const long long r = (static_cast<long long>(b) * H + h) * Tq + row;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[16], dor[16], acc[16], x[16], y[16];
  load_row<TPR>(q + b * sq.b + h * sq.h + static_cast<long long>(row) * sq.t,
                live, sl, D, qr);
  load_row<TPR>(dout + b * sdo.b + h * sdo.h + static_cast<long long>(row) * sdo.t,
                live, sl, D, dor);
  load_row<TPR>(o + r * D, live, sl, D, x);
  const float di = dot<TPR>(dor, x);  // rowsum(do . o) in f32
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const float mrow = live ? m[r] : 0.f;
  const float lrow = live ? l[r] : 1.f;
  const float linv = lrow == 0.f ? 1.f : 1.f / lrow;
  const int lim = live ? dl4j::flash_key_limit<DP>(row, Tq, Tk, causal) : 0;
  if (live && sl == 0) di_out[r] = di;

  // keys [0, kend): the largest limit of the block's rows, its last live row's
  const int kend = dl4j::flash_key_limit<DP>(min(row0 + S - 1, Tq - 1), Tq, Tk,
                                             causal);
  const int ntiles = (kend + S - 1) / S;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * S;
    __syncthreads();  // the previous tile has been read by every row
    stage<DP, S, NT>(ks, kb, sk.t, k0, Tk, D, tid);
    stage<DP, S, NT>(vs, vb, sv.t, k0, Tk, D, tid);
    for (int j = tid; j < S; j += NT) {
      const int col = k0 + j;
      mask_s[j] = (key_mask != nullptr && col < Tk)
                      ? key_mask[static_cast<long long>(b) * Tk + col]
                      : 1.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < S; ++j) {
      chunk<TPR>(ks + j * DP, sl, x);
      chunk<TPR>(vs + j * DP, sl, y);
      const float s = dot<TPR>(qr, x);
      const float dp = dot<TPR>(dor, y);
      const int col = k0 + j;
      float p = 0.f;
      if (col < lim) {
        p = expf(dl4j::masked_score(s, scale, row, col, Tk, off, causal,
                                    mask_s[j]) - mrow) * linv;
      }
      axpy(round_like<T>(p * (dp - di) * scale), x, acc);
    }
  }
  store_row<TPR>(dq + r * D, live, sl, D, acc);
}

template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<DP>::NT)
    ffma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ key_mask,
                     const T* __restrict__ dout, const float* __restrict__ l,
                     const float* __restrict__ m, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                     int Tk, int D, Strides sq, Strides sk, Strides sv,
                     Strides sdo, int causal, float scale) {
  constexpr int TPR = BwdCfg<DP>::TPR;
  constexpr int S = BwdCfg<DP>::S;
  constexpr int NT = BwdCfg<DP>::NT;
  __shared__ __align__(16) float qs[S * DP];
  __shared__ __align__(16) float dos[S * DP];
  __shared__ float m_s[S], linv_s[S], di_s[S];
  __shared__ int lim_s[S];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int col0 = static_cast<int>(blockIdx.x) * S;
  const int col = col0 + tid / TPR;
  const bool live = col < Tk;
  const int off = Tk - Tq;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* db = dout + b * sdo.b + h * sdo.h;

  float kr[16], vr[16], dkr[16], dvr[16], x[16], y[16];
  load_row<TPR>(k + b * sk.b + h * sk.h + static_cast<long long>(col) * sk.t, live,
                sl, D, kr);
  load_row<TPR>(v + b * sv.b + h * sv.h + static_cast<long long>(col) * sv.t, live,
                sl, D, vr);
#pragma unroll
  for (int i = 0; i < 16; ++i) dkr[i] = dvr[i] = 0.f;
  const float kmask =
      (live && key_mask != nullptr) ? key_mask[static_cast<long long>(b) * Tk + col]
                                    : 1.f;

  // the first query tile with a row whose forward visited key col0 (a row's
  // key limit grows with the row)
  const int nq = (Tq + S - 1) / S;
  int i0 = 0;
  while (causal && i0 < nq &&
         dl4j::flash_key_limit<DP>(min(i0 * S + S - 1, Tq - 1), Tq, Tk, causal) <=
             col0) {
    ++i0;
  }
  for (int it = i0; it < nq; ++it) {
    const int r0 = it * S;
    __syncthreads();  // the previous tile has been read by every key row
    stage<DP, S, NT>(qs, qb, sq.t, r0, Tq, D, tid);
    stage<DP, S, NT>(dos, db, sdo.t, r0, Tq, D, tid);
    for (int j = tid; j < S; j += NT) {
      const int row = r0 + j;
      const bool ok = row < Tq;
      const float lv = ok ? l[bh * Tq + row] : 1.f;
      m_s[j] = ok ? m[bh * Tq + row] : 0.f;
      linv_s[j] = lv == 0.f ? 1.f : 1.f / lv;
      di_s[j] = ok ? di[bh * Tq + row] : 0.f;
      lim_s[j] = ok ? dl4j::flash_key_limit<DP>(row, Tq, Tk, causal) : 0;
    }
    __syncthreads();
    // not unrolled: a second copy of x and y would spill (k, v and the two
    // accumulators already hold 64 registers)
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      chunk<TPR>(qs + j * DP, sl, x);
      chunk<TPR>(dos + j * DP, sl, y);
      const float s = dot<TPR>(kr, x);
      const float dp = dot<TPR>(vr, y);
      float p = 0.f;  // rows past Tq have limit 0
      if (col < lim_s[j]) {
        p = expf(dl4j::masked_score(s, scale, r0 + j, col, Tk, off, causal,
                                    kmask) - m_s[j]) * linv_s[j];
      }
      axpy(round_like<T>(p), y, dvr);
      axpy(round_like<T>(p * (dp - di_s[j]) * scale), x, dkr);
    }
  }
  const long long c = bh * Tk + col;
  store_row<TPR>(dk + c * D, live, sl, D, dkr);
  store_row<TPR>(dv + c * D, live, sl, D, dvr);
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *o;
  const float *mask, *l, *m;
  void *dq, *dk, *dv;
  float* di;
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, sdo;
  int causal;
  float scale;
  int device;
};

// 16-byte cp.async takes every tile row of q, k, v and do
template <typename T>
bool rows_aligned(const BwdArgs& a) {
  return dl4j::rows_aligned<T>({a.q, a.k, a.v, a.dout},
                                {a.sq, a.sk, a.sv, a.sdo});
}

template <typename T, int DP>
cudaError_t launch_mma_dq(const BwdArgs& a, cudaStream_t stream) {
  using C = MmaCfg<T, DP>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err =
      mma::allow_smem(mma_dq_kernel<T, DP>, C::kSmem, a.device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + C::BM - 1) / C::BM);
  mma_dq_kernel<T, DP><<<grid, C::NT, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      static_cast<const T*>(a.o), a.l, a.m, static_cast<T*>(a.dq), a.di, a.H, a.Tq,
      a.Tk, a.D, a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale,
      rows_aligned<T>(a) ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_mma_dkv(const BwdArgs& a, cudaStream_t stream) {
  using C = MmaCfg<T, DP>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err =
      mma::allow_smem(mma_dkv_kernel<T, DP>, C::kSmem, a.device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tk + C::BM - 1) / C::BM);
  mma_dkv_kernel<T, DP><<<grid, C::NT, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout), a.l, a.m,
      a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Tq, a.Tk, a.D,
      a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale, rows_aligned<T>(a) ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_ffma_dq(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + BwdCfg<DP>::S - 1) / BwdCfg<DP>::S, a.H, a.B);
  ffma_dq_kernel<T, DP><<<grid, BwdCfg<DP>::NT, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      static_cast<const T*>(a.o), a.l, a.m, static_cast<T*>(a.dq), a.di, a.H, a.Tq,
      a.Tk, a.D, a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_ffma_dkv(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Tk + BwdCfg<DP>::S - 1) / BwdCfg<DP>::S, a.H, a.B);
  ffma_dkv_kernel<T, DP><<<grid, BwdCfg<DP>::NT, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout), a.l, a.m,
      a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Tq, a.Tk, a.D,
      a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale);
  return cudaGetLastError();
}

// by head size, before launch: the tensor-core kernels up to DP = 128, the FFMA
// kernels above
template <typename T, bool kDq>
cudaError_t dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.D <= 32) return kDq ? launch_mma_dq<T, 32>(a, s) : launch_mma_dkv<T, 32>(a, s);
  if (a.D <= 64) return kDq ? launch_mma_dq<T, 64>(a, s) : launch_mma_dkv<T, 64>(a, s);
  if (a.D <= 128) {
    return kDq ? launch_mma_dq<T, 128>(a, s) : launch_mma_dkv<T, 128>(a, s);
  }
  if (a.D <= 256) {
    return kDq ? launch_ffma_dq<T, 256>(a, s) : launch_ffma_dkv<T, 256>(a, s);
  }
  if (a.D <= 512) {
    return kDq ? launch_ffma_dq<T, 512>(a, s) : launch_ffma_dkv<T, 512>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kDq>
int run(BwdArgs a, int dtype, int device, void* stream) {
  if (a.B < 0 || a.H < 0 || a.Tq < 0 || a.Tk < 0 || a.D <= 0 || a.D > 512 ||
      a.H > 65535 || a.B > 65535 ||
      static_cast<long long>(a.B) * a.H > 2147483647LL ||
      (a.Tq + 63) / 64 > 65535 || (a.Tk + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.B == 0 || a.H == 0 || a.Tq == 0 || a.Tk == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float, kDq>(a, s));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16, kDq>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, do [B,H,Tq,D] and k, v [B,H,Tk,D] with element strides (b, h, t) and unit D
// stride; key_mask: float32 [B, Tk] (contiguous) or null; o [B,H,Tq,D] and dq
// contiguous in the input dtype; l, m, di [B,H,Tq] float32 contiguous (di is
// written). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 =
// launched); the launch is asynchronous on `stream`.
int dl4j_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* key_mask, const void* dout,
                                const void* o, const void* l, const void* m,
                                void* dq, void* di, int B, int H, int Tq, int Tk,
                                int D, long long q_sb, long long q_sh,
                                long long q_st, long long k_sb, long long k_sh,
                                long long k_st, long long v_sb, long long v_sh,
                                long long v_st, long long do_sb, long long do_sh,
                                long long do_st, int causal, float scale,
                                int dtype, int device, void* stream) {
  BwdArgs a{q, k, v, dout, o,
            static_cast<const float*>(key_mask), static_cast<const float*>(l),
            static_cast<const float*>(m), dq, nullptr, nullptr,
            static_cast<float*>(di), B, H, Tq, Tk, D,
            Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
            Strides{v_sb, v_sh, v_st}, Strides{do_sb, do_sh, do_st}, causal,
            scale, device};
  return run<true>(a, dtype, device, stream);
}

// As above, after dl4j_flash_attention_bwd_dq on the same stream: reads its di;
// dk, dv [B,H,Tk,D] contiguous in the input dtype are written.
int dl4j_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* l, const void* m, const void* di,
                                 void* dk, void* dv, int B, int H, int Tq, int Tk,
                                 int D, long long q_sb, long long q_sh,
                                 long long q_st, long long k_sb, long long k_sh,
                                 long long k_st, long long v_sb, long long v_sh,
                                 long long v_st, long long do_sb, long long do_sh,
                                 long long do_st, int causal, float scale,
                                 int dtype, int device, void* stream) {
  BwdArgs a{q, k, v, dout, nullptr,
            static_cast<const float*>(key_mask), static_cast<const float*>(l),
            static_cast<const float*>(m), nullptr, dk, dv,
            const_cast<float*>(static_cast<const float*>(di)), B, H, Tq, Tk, D,
            Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
            Strides{v_sb, v_sh, v_st}, Strides{do_sb, do_sh, do_st}, causal,
            scale, device};
  return run<false>(a, dtype, device, stream);
}

}  // extern "C"
