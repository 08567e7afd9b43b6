// The tensor-core main loop of the port's float GEMM kernels
// (matmul_bias_act.cu, matmul_stats.cu): one block accumulates a BM x BN tile
// of x[M,K] . w[N,K]^T in f32 registers, and each kernel runs its own
// epilogue on the accumulator fragments.
//
// Warps: (BM / WM) x (BN / WN) warps, each owning a WM x WN sub-tile as
// (WM / 16) x (WN / 8) m16n8 accumulator fragments (layouts in mma_tiles.cuh).
// K is walked in steps of BK = 32 elements through a 3-stage ring of 16-byte
// cp.async copies, two steps in flight while one is computed; rows past M or
// N and columns past K are zero-filled, and a K that leaves rows off 16 bytes,
// or a misaligned operand, takes element loads (load_tile). float32 takes
// three TF32 MMAs a product through the 3xTF32 split (f32 accuracy), each
// fragment split in registers where it is loaded; bfloat16 takes one m16n8k16
// bf16 MMA, f32 accumulation.
//
// Each output sums its K products in k order by steps of 8 (tf32) or 16
// (bf16); the order depends on the output's row and column data and on K
// only, never on the tile or on M: no split-K, so a row's output is the same
// in every batch bucket it is served in. The tensor cores round each
// accumulation toward zero. Straight (kFresh false) every output lives in one
// accumulator, which costs up to 3 K / 8 roundings of the sum's size in
// float32: at ResNet-50's K <= 2048 that stays within a third of the
// 1e-4 + 1e-4 |y| matmul_bias_act is held to, but it biases every |y| low, and
// sum(y^2) by twice as much. With kFresh each BK step's products are summed
// into a zeroed fragment and added to the accumulator with an ordinary
// (round-to-nearest) f32 add, so the bias is that of 32-term sums, whatever K.
#pragma once

#include <type_traits>

#include "mma_tiles.cuh"

namespace dl4j {
namespace tc {

template <typename T, int BM_, int BN_, int WM_, int WN_>
struct Gemm {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int BK = 32, kStages = 3;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int NT = (BM / WM) * kWarpsN * 32;
  static constexpr int MT = WM / 16, NTL = WN / 8;  // fragments of a warp
  static constexpr int LD = mma::tile_ld<T>(BK);
  static constexpr int kStage = (BM + BN) * LD;  // x rows, then w rows
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(T));
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0,
                "warp tiles");
};

// 128 x 64 block tiles where the problem has two of them for each SM, else
// 64 x 64 (4 warps each; both fit two or more blocks an SM)
inline bool wide_tiles(int m, int n, int num_sms) {
  const long tiles = static_cast<long>((m + 127) / 128) * ((n + 63) / 64);
  return tiles >= 2L * num_sms;
}

// d[mt][nt] += X . Y^T over one BK step: X the warp's WM rows of a staged x
// tile, Y its WN rows of the w tile (row stride LD, k contiguous).
template <typename T, int MT, int NTL, int BK, int LD>
__device__ __forceinline__ void warp_mma(float (&d)[MT][NTL][4],
                                         const T* __restrict__ X,
                                         const T* __restrict__ Y, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* xp = X + (mt * 16 + g) * LD + kk + t;
        mma::split_tf32(xp[0], ab[mt][0], as[mt][0]);
        mma::split_tf32(xp[8 * LD], ab[mt][1], as[mt][1]);
        mma::split_tf32(xp[4], ab[mt][2], as[mt][2]);
        mma::split_tf32(xp[8 * LD + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const float* yp = Y + (nt * 8 + g) * LD + kk + t;
        uint32_t bb[2], bs[2];
        mma::split_tf32(yp[0], bb[0], bs[0]);
        mma::split_tf32(yp[4], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma::mma_3xtf32(d[mt][nt], ab[mt], as[mt], bb, bs);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* xp = X + (mt * 16 + g) * LD + kk + 2 * t;
        a[mt][0] = mma::lds32(xp);
        a[mt][1] = mma::lds32(xp + 8 * LD);
        a[mt][2] = mma::lds32(xp + 8);
        a[mt][3] = mma::lds32(xp + 8 * LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const T* yp = Y + (nt * 8 + g) * LD + kk + 2 * t;
        const uint32_t b[2] = {mma::lds32(yp), mma::lds32(yp + 8)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma::mma_bf16(d[mt][nt], a[mt], b);
      }
    }
  }
}

// acc = x[row0 : row0 + BM, :] . w[col0 : col0 + BN, :]^T (rows past M or N
// give 0) for the calling warp's fragments: warp wm = warp / kWarpsN owns
// rows wm * WM + [0, WM) of the tile, wn = warp % kWarpsN columns
// wn * WN + [0, WN). `smem` holds G::kSmem bytes (dynamic shared memory);
// vec: 16-byte aligned x and w with K * sizeof(T) a multiple of 16. kFresh:
// each K step summed fresh, then added to acc (see the top of the file).
template <typename G, bool kFresh = false, typename T>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ x,
                                          const T* __restrict__ w, int M, int N,
                                          int K, int row0, int col0, bool vec,
                                          T* __restrict__ smem,
                                          float (&acc)[G::MT][G::NTL][4]) {
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, LD = G::LD, NT = G::NT;
  constexpr int S = G::kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;

#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  auto load = [&](int i) {  // K step i into stage i % S
    T* st = smem + (i % S) * G::kStage;
    const int k0 = i * BK;
    mma::load_tile<T, BM, BK, LD, NT>(st, x + k0, K, row0, M, K - k0, vec, tid);
    mma::load_tile<T, BN, BK, LD, NT>(st + BM * LD, w + k0, K, col0, N, K - k0,
                                      vec, tid);
  };
  for (int i = 0; i < S - 1; ++i) {
    if (i < nk) load(i);
    mma::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    mma::cp_async_wait<S - 2>();  // step i (one group per step, empty ones too)
    __syncthreads();  // ... visible; every warp is done with step i - 1
    if (i + S - 1 < nk) load(i + S - 1);  // into step i - 1's stage
    mma::cp_async_commit();
    const T* xs = smem + (i % S) * G::kStage;
    if constexpr (kFresh) {
      float part[G::MT][G::NTL][4] = {};
      warp_mma<T, G::MT, G::NTL, BK, LD>(part, xs + wm * G::WM * LD,
                                         xs + (BM + wn * G::WN) * LD, lane);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NTL; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    } else {
      warp_mma<T, G::MT, G::NTL, BK, LD>(acc, xs + wm * G::WM * LD,
                                         xs + (BM + wn * G::WN) * LD, lane);
    }
  }
}

}  // namespace tc
}  // namespace dl4j
