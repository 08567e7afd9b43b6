// Flash attention forward for Hopper: o = softmax(scale * q . k^T, masked) . v over
// [B, H, T, D] operands, with the row statistics l (sum of exp) and m (row max).
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/attention.py::_fwd_kernel
// (_flash_fwd_impl / flash_attention), which walks key blocks in the TPU grid's
// sequential innermost dimension with the running max, sum and output kept in
// VMEM scratch, skips key blocks above the causal diagonal and stores o, l, m.
//
// What bounds it on an H100: the prompt prefill (T up to 1024, D = 64) does
// 4 * B * H * Tq * Tk * D * (1/2 causal) operations on 4 * B * H * T * D values,
// about T / 4 operations per byte in float32, so operations bound it at every
// prompt longer than a few dozen tokens. f32 stays f32 accurate: the two
// products run on the tensor cores through the 3xTF32 split (mma_tiles.cuh:
// three TF32 MMAs a product, 495 / 3 = 165 TFLOP/s against 67 for FFMA); bf16
// runs one bf16 MMA a product with f32 accumulation.
//
// Design (DP = 32, 64, 128; D padded up to them): one block of 4 warps owns 64
// query rows of one (b, h), 16 a warp; a loop inside the block replaces the
// TPU's sequential grid dimension. Q stays in shared memory; K and V tiles of
// BN keys (32, or 16 at DP = 128) come by 16-byte cp.async through a 2-stage
// ring (rows past Tk zero-filled; a misaligned operand takes element loads,
// chosen on the host), and in f32 each staged tile is split once in shared
// memory for the 4 warps. Per tile a warp computes S = Q . K^T into
// accumulator registers (mma_abt), scales and masks it there, runs the online
// softmax on the fragments (a row's max and sum across the 4 lanes of a quad),
// and adds P . V (mma_ckn: P feeds the product from the accumulators, tf32
// through its permuted k order, bf16 packed). Tiles below the causal diagonal
// with every key inside Tk and kept by the key mask (a warp vote as the mask
// is staged) skip the per-element mask test. The
// tensor cores round each accumulation toward zero, so in f32 each tile's
// P . V is summed from zero and then added to the f32 running O (kFresh); m and
// l stay f32, l sums the unrounded p, and o is divided by l once at the end
// (l == 0, a row with no key visited, divides by 1). In bf16, p is rounded to
// bf16 before the P . V product, as the TPU kernel casts it to v's dtype. The
// grid puts the query tile in its slow dimension, last tile (the longest
// causal rows) first.
//
// The mask rule (flash_common.cuh): the key mask (float, tested > 0) and the
// causal rule col <= row + (Tk - Tq) SET masked scores to -1e30 (NEG_INF of the
// JAX package, so a fully masked row stays finite), and keys past Tk (the
// ragged last tile, which the TPU kernel padded instead) score -inf and weigh
// exactly 0. The scale multiplies each f32 dot product after it is formed.
// The loop visits keys up to flash_key_limit of the block's last row: whole
// FlashCfg<DP>::BK tiles, which the backward kernels weigh for a row with no
// valid key.
//
// Head sizes 256 and 512 (DP = 256, 512): the accumulators of 16 rows x DP do
// not fit a warp's registers, so the dispatch chooses the FFMA kernel below by
// head size before launch (never after a failure): TPR lanes own a query row,
// each holding DP / TPR of its q values and of its f32 output accumulator,
// the lanes' partial dot products summed by an xor shuffle; K and V tiles of
// FlashCfg<DP>::BK keys staged as f32 in static shared memory.

#include <atomic>
#include <cstdint>

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace {

using dl4j::FlashCfg;
using dl4j::kNegInf;
using dl4j::round_like;
using dl4j::Strides;
namespace mma = dl4j::mma;

// ---------------------------------------------------------------------------
// tensor-core kernel, DP = 32, 64, 128
// ---------------------------------------------------------------------------

// A block of NT threads (4 warps) owns BM = FlashCfg<DP>::BQ query rows, 16 a
// warp, and walks the keys in staged tiles of BN rows (a divisor of
// FlashCfg<DP>::BK); shared tiles have row stride LD (mma_tiles.cuh). Shared
// memory: the Q tile, a 2-stage ring of K and V tiles, in f32 the small halves
// of the current K and V tiles (split_tile), and each stage's key mask and
// whether it keeps every key of the tile.
template <typename T, int DP>
struct FwdCfg {
  static constexpr int NT = 128, BM = FlashCfg<DP>::BQ;
  static constexpr int BN = DP <= 64 ? 32 : 16;
  static constexpr int LD = mma::tile_ld<T>(DP);
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr int kSmem =
      (BM + (kSplit ? 6 : 4) * BN) * LD * static_cast<int>(sizeof(T)) +
      2 * (BN + 1) * 4;
  static_assert(BM == 4 * 16 && FlashCfg<DP>::BK % BN == 0 && BN <= 32,
                "tiles: the key mask is staged by warp 0");
};

// m and l of a row (this lane's share of l: its columns' p), and the online
// softmax of a tile of its scores: the row max across the 4 lanes of a quad,
// the running values rescaled, s replaced by p = exp(s - m); alpha_a and
// alpha_b receive the rescale factors of the two rows' earlier sums.
struct RowState {
  float m = kNegInf, l = 0.f;
};

template <int NK>
__device__ __forceinline__ void softmax_rows(float (&s)[NK][4], RowState& a,
                                             RowState& b, float& alpha_a,
                                             float& alpha_b) {
  float mx_a = a.m, mx_b = b.m;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
  }
  alpha_a = expf(a.m - mx_a);
  alpha_b = expf(b.m - mx_b);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    s[j][0] = expf(s[j][0] - mx_a);
    s[j][1] = expf(s[j][1] - mx_a);
    s[j][2] = expf(s[j][2] - mx_b);
    s[j][3] = expf(s[j][3] - mx_b);
    sum_a += s[j][0] + s[j][1];
    sum_b += s[j][2] + s[j][3];
  }
  a.l = a.l * alpha_a + sum_a;
  b.l = b.l * alpha_b + sum_b;
  a.m = mx_a;
  b.m = mx_b;
}

template <typename T, int DP>
__global__ void __launch_bounds__(FwdCfg<T, DP>::NT)
    mma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ key_mask,
                   T* __restrict__ o, float* __restrict__ l_out,
                   float* __restrict__ m_out, int H, int Tq, int Tk, int D,
                   Strides sq, Strides sk, Strides sv, int causal, float scale,
                   int vec) {
  using C = FwdCfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NT = C::NT;
  constexpr int NK = BN / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* ks = qs + BM * LD;                // [2][BN][LD]
  T* vs = ks + 2 * BN * LD;            // [2][BN][LD]
  T* ksm = vs + 2 * BN * LD;           // [BN][LD], f32 only: the small halves
  T* vsm = ksm + BN * LD;              // [BN][LD]
  float* mask_s = reinterpret_cast<float*>(
      C::kSplit ? vsm + BN * LD : ksm);  // [2][BN]
  int* full_s = reinterpret_cast<int*>(mask_s + 2 * BN);  // [2]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // the last query tile (the longest causal rows) first
  const int row0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  // keys [0, kend): the causal diagonal of the block's last row bounds them
  const int kend = dl4j::flash_key_limit<DP>(row0, Tq, Tk, causal);
  const int ntiles = (kend + BN - 1) / BN;

  mma::load_tile<T, BM, DP, LD, NT>(qs, q + b * sq.b + h * sq.h, sq.t, row0, Tq,
                                    D, vec, tid);
  if (ntiles > 0) {
    mma::load_tile<T, BN, DP, LD, NT>(ks, kb, sk.t, 0, Tk, D, vec, tid);
    mma::load_tile<T, BN, DP, LD, NT>(vs, vb, sv.t, 0, Tk, D, vec, tid);
  }
  mma::cp_async_commit();
  // the key mask of a tile, staged by warp 0 (lane j: key k0 + j), and
  // whether it keeps every key of the tile
  const auto stage_mask = [&](int st, float mv) {
    const bool all = __all_sync(0xffffffffu, lane >= BN || mv > 0.f);
    if (lane < BN) mask_s[st * BN + lane] = mv;
    if (lane == 0) full_s[st] = all;
  };
  if (key_mask != nullptr && warp == 0) {
    stage_mask(0, lane < BN && lane < Tk
                      ? key_mask[static_cast<long long>(b) * Tk + lane]
                      : 1.f);
  }
  const int ra = row0 + warp * 16 + g;  // the thread's rows ra and ra + 8

  float acc[DP / 8][4] = {};
  RowState sa, sb;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = it * BN;
    const bool more = it + 1 < ntiles;
    mma::cp_async_wait<0>();  // this tile's K and V (and Q)
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
    if (key_mask != nullptr && more && warp == 0 && lane < BN &&
        k0 + BN + lane < Tk) {
      mask_next = key_mask[static_cast<long long>(b) * Tk + k0 + BN + lane];
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
    if ((key_mask == nullptr || full_s[st] != 0) && k0 + BN <= Tk &&
        (!causal || k0 + BN - 1 <= row0 + off)) {
      // every key of the tile is visible to every row of the block
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      }
    } else {
      const float* ms = mask_s + st * BN;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          s[j][e] = dl4j::masked_score(s[j][e], scale, ra + (e < 2 ? 0 : 8),
                                       k0 + c, Tk, off, causal,
                                       key_mask != nullptr ? ms[c] : 1.f);
        }
      }
    }
    float alpha_a, alpha_b;
    softmax_rows<NK>(s, sa, sb, alpha_a, alpha_b);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha_a;
      acc[n][1] *= alpha_a;
      acc[n][2] *= alpha_b;
      acc[n][3] *= alpha_b;
    }
    mma::mma_ckn<T, NK, DP / 8, LD, C::kSplit>(acc, s, vt, vsm, lane);  // P . V
    if (key_mask != nullptr && more && warp == 0) stage_mask(st ^ 1, mask_next);
  }
  mma::cp_async_wait<0>();  // Q, when the block visits no key

  // l: the sum of the quad's shares; o = acc / l
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    sa.l += __shfl_xor_sync(0xffffffffu, sa.l, w);
    sb.l += __shfl_xor_sync(0xffffffffu, sb.l, w);
  }
  const float ia = sa.l == 0.f ? 1.f : 1.f / sa.l;
  const float ib = sb.l == 0.f ? 1.f : 1.f / sb.l;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] *= ia;
    acc[n][1] *= ia;
    acc[n][2] *= ib;
    acc[n][3] *= ib;
  }
  mma::store_acc<T, DP / 8>(o + bh * Tq * D, acc, ra, Tq, D, t);
  if (t == 0) {
    if (ra < Tq) {
      l_out[bh * Tq + ra] = sa.l;
      m_out[bh * Tq + ra] = sa.m;
    }
    if (ra + 8 < Tq) {
      l_out[bh * Tq + ra + 8] = sb.l;
      m_out[bh * Tq + ra + 8] = sb.m;
    }
  }
}

// ---------------------------------------------------------------------------
// FFMA kernel, DP = 256 and 512: TPR lanes own a row (a matrix-vector design)
// ---------------------------------------------------------------------------

constexpr int kTPR = 8;  // lanes a query row

template <typename T, int DP>
__global__ void __launch_bounds__(FlashCfg<DP>::BQ * kTPR)
    ffma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_mask,
                    T* __restrict__ o, float* __restrict__ l_out,
                    float* __restrict__ m_out, int H, int Tq, int Tk, int D,
                    Strides sq, Strides sk, Strides sv, int causal, float scale) {
  constexpr int TPR = kTPR;
  constexpr int BQ = FlashCfg<DP>::BQ;
  constexpr int BK = FlashCfg<DP>::BK;
  constexpr int NT = BQ * TPR;
  constexpr int DPT = DP / TPR;  // values of a row per lane
  constexpr int NC = DPT / 4;    // float4 chunks per lane
  __shared__ __align__(16) float ks[BK * DP];
  __shared__ __align__(16) float vs[BK * DP];
  __shared__ float mask_s[BK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int row0 = static_cast<int>(blockIdx.x) * BQ;
  const int row = row0 + tid / TPR;
  const int off = Tk - Tq;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      qr[c * 4 + e] = (row < Tq && d < D)
                          ? dl4j::to_f32(qb[static_cast<long long>(row) * sq.t + d])
                          : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // keys [0, kend): the causal diagonal of the block's last row bounds them
  const int kend = dl4j::flash_key_limit<DP>(row0, Tq, Tk, causal);
  const int ntiles = (kend + BK - 1) / BK;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile has been read by every row
    for (int i = tid; i < BK * DP; i += NT) {
      const int j = i / DP, d = i % DP;
      const int col = k0 + j;
      const bool ok = col < Tk && d < D;
      ks[i] = ok ? dl4j::to_f32(kb[static_cast<long long>(col) * sk.t + d]) : 0.f;
      vs[i] = ok ? dl4j::to_f32(vb[static_cast<long long>(col) * sv.t + d]) : 0.f;
    }
    for (int j = tid; j < BK; j += NT) {
      const int col = k0 + j;
      mask_s[j] = (key_mask != nullptr && col < Tk)
                      ? key_mask[static_cast<long long>(b) * Tk + col]
                      : 1.f;
    }
    __syncthreads();

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DP);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[sl + TPR * c];
        part = fmaf(qr[c * 4 + 0], kk.x, part);
        part = fmaf(qr[c * 4 + 1], kk.y, part);
        part = fmaf(qr[c * 4 + 2], kk.z, part);
        part = fmaf(qr[c * 4 + 3], kk.w, part);
      }
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, w);
      }
      const float sc = dl4j::masked_score(part, scale, row, k0 + j, Tk, off,
                                          causal, mask_s[j]);
      s[j] = sc;
      tmax = fmaxf(tmax, sc);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pv = round_like<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DP);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[sl + TPR * c];
        acc[c * 4 + 0] = fmaf(pv, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(pv, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(pv, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(pv, vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (row < Tq) {
    const long long r = (static_cast<long long>(b) * H + h) * Tq + row;
    const float linv = l == 0.f ? 1.f : 1.f / l;
    T* orow = o + r * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (sl + TPR * c) * 4 + e;
        if (d < D) orow[d] = dl4j::from_f32<T>(acc[c * 4 + e] * linv);
      }
    }
    if (sl == 0) {
      l_out[r] = l;
      m_out[r] = m;
    }
  }
}

template <typename T, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* l, float* m, int B,
                       int H, int Tq, int Tk, int D, Strides sq, Strides sk,
                       Strides sv, int causal, float scale, int device,
                       cudaStream_t stream) {
  using C = FwdCfg<T, DP>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err =
      mma::allow_smem(mma_fwd_kernel<T, DP>, C::kSmem, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + C::BM - 1) / C::BM);
  mma_fwd_kernel<T, DP><<<grid, C::NT, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), l, m, H, Tq, Tk, D, sq, sk, sv, causal, scale,
      dl4j::rows_aligned<T>({q, k, v}, {sq, sk, sv}) ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_ffma(const void* q, const void* k, const void* v,
                        const float* mask, void* o, float* l, float* m, int B,
                        int H, int Tq, int Tk, int D, Strides sq, Strides sk,
                        Strides sv, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int BQ = FlashCfg<DP>::BQ;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  ffma_fwd_kernel<T, DP><<<grid, BQ * kTPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), l, m, H, Tq, Tk, D, sq, sk, sv, causal, scale);
  return cudaGetLastError();
}

// by head size, before launch: the tensor-core kernel up to DP = 128, the FFMA
// kernel above
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* mask,
                     void* o, float* l, float* m, int B, int H, int Tq, int Tk,
                     int D, Strides sq, Strides sk, Strides sv, int causal,
                     float scale, int dev, cudaStream_t s) {
  if (D <= 32) return launch_mma<T, 32>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, dev, s);
  if (D <= 64) return launch_mma<T, 64>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, dev, s);
  if (D <= 128) return launch_mma<T, 128>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, dev, s);
  if (D <= 256) return launch_ffma<T, 256>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  if (D <= 512) return launch_ffma<T, 512>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  return cudaErrorInvalidValue;
}

// The (BQ, BK) pair of FlashCfg for head size D: the one tiling instantiated
// for it (and the backward's visited-key rule), so the only one a caller may ask for.
template <int DP>
bool is_cfg(int bq, int bk) {
  return bq == FlashCfg<DP>::BQ && bk == FlashCfg<DP>::BK;
}

bool tiles_ok(int D, int bq, int bk) {
  if (bq == 0 && bk == 0) return true;  // the default: FlashCfg of D
  if (D <= 32) return is_cfg<32>(bq, bk);
  if (D <= 64) return is_cfg<64>(bq, bk);
  if (D <= 128) return is_cfg<128>(bq, bk);
  if (D <= 256) return is_cfg<256>(bq, bk);
  return is_cfg<512>(bq, bk);
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] with element strides (b, h, t) and unit D stride;
// key_mask: float32 [B, Tk] (contiguous) or null; o [B,H,Tq,D] contiguous in the
// input dtype; l, m [B,H,Tq] float32. dtype: 0 = float32, 1 = bfloat16.
// (block_q, block_k): FlashCfg's pair for D, or (0, 0) for it. Returns a
// cudaError_t (0 = launched); the launch is asynchronous on `stream`.
int dl4j_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_mask, void* o, void* l, void* m,
                             int B, int H, int Tq, int Tk, int D,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             int causal, float scale, int dtype, int block_q,
                             int block_k, int device, void* stream) {
  if (B < 0 || H < 0 || Tq < 0 || Tk < 0 || D <= 0 || D > 512 ||
      !tiles_ok(D, block_q, block_k) || H > 65535 || B > 65535 ||
      static_cast<long long>(B) * H > 2147483647LL || (Tq + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  const Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, sv{v_sb, v_sh, v_st};
  const float* mask = static_cast<const float*>(key_mask);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = dispatch<float>(q, k, v, mask, o, lp, mp, B, H, Tq, Tk, D, sq, sk, sv,
                            causal, scale, device, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(q, k, v, mask, o, lp, mp, B, H, Tq, Tk, D, sq,
                                    sk, sv, causal, scale, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
