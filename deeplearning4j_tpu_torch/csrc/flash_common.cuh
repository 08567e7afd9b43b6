// What the flash attention kernels share: the forward's tiles, the mask rule,
// and the set of keys the forward visits for a query row.
//
// csrc/flash_attention.cu (the forward) and csrc/flash_attention_bwd.cu (the dq
// and dk/dv kernels) include it. The backward recomputes p = exp(s - m) / l from
// the forward's row statistics, so it must mask every score as the forward did
// and, for a row with no valid key (every score masked to -1e30, so m = -1e30
// and p = 1 / l at every key the forward visited), weigh the keys the forward
// visited and no others.
#pragma once

#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

#include "ffma_gemm.cuh"

namespace dl4j {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package

// The forward's tiles by padded head size DP (D <= DP): BQ query rows a block,
// and the key tile BK to which a causal row's visited keys are rounded
// (flash_key_limit). The tensor-core forward (DP <= 128) stages key tiles of a
// size that divides BK; the FFMA forward (DP = 256, 512) stages BK keys.
template <int DP>
struct FlashCfg;
template <>
struct FlashCfg<32> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct FlashCfg<64> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct FlashCfg<128> {
  static constexpr int BQ = 64, BK = 32;
};
template <>
struct FlashCfg<256> {
  static constexpr int BQ = 32, BK = 16;
};
template <>
struct FlashCfg<512> {
  static constexpr int BQ = 32, BK = 8;
};

// Element strides of one [B, H, T, D] operand (D stride 1).
struct Strides {
  long long b, h, t;
};

// 16-byte cp.async takes every tile row of the operands: their bases and
// (b, h, t) strides are 16-byte multiples
template <typename T>
inline bool rows_aligned(std::initializer_list<const void*> bases,
                         std::initializer_list<Strides> strides) {
  constexpr long long e = sizeof(T);
  for (const void* p : bases) {
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  }
  for (const Strides& s : strides) {
    if ((s.b * e) % 16 != 0 || (s.h * e) % 16 != 0 || (s.t * e) % 16 != 0) {
      return false;
    }
  }
  return true;
}

// p rounded as the TPU kernels cast it to the operand dtype before a product.
template <typename T>
__device__ __forceinline__ float round_like(float p);
template <>
__device__ __forceinline__ float round_like<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// The mask rule: key col of query row scores the f32 dot product times the
// scale, or -1e30 where the key mask is not > 0 or the key is above the causal
// diagonal (col > row + Tk - Tq); keys past Tk (a ragged last tile) score -inf
// and weigh exactly 0.
__device__ __forceinline__ float masked_score(float dot, float scale, int row,
                                              int col, int Tk, int off,
                                              int causal, float key_mask) {
  if (col >= Tk) return -CUDART_INF_F;
  if (!(key_mask > 0.f) || (causal && col > row + off)) return kNegInf;
  return dot * scale;
}

// The forward visits keys [0, limit) for a query row: all Tk keys, or with causal
// the whole key tiles up to the diagonal of the last row of the row's query tile.
template <int DP>
__device__ __forceinline__ int flash_key_limit(int row, int Tq, int Tk,
                                               int causal) {
  if (!causal) return Tk;
  constexpr int BQ = FlashCfg<DP>::BQ, BK = FlashCfg<DP>::BK;
  const int last = min((row / BQ) * BQ + BQ - 1, Tq - 1);
  const int kend = min(Tk, last + (Tk - Tq) + 1);
  return kend > 0 ? min(Tk, (kend + BK - 1) / BK * BK) : 0;
}

}  // namespace dl4j
