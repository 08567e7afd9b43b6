// The FFMA main loop of matmul_stats.cu: one block accumulates a BM x BN tile
// of x[M,K] . w[N,K]^T in f32 registers, and the kernel runs its epilogue on
// the accumulator. matmul_bias_act.cu runs on the tensor cores instead
// (tc_gemm.cuh); the dtype conversions and the device helpers at the end of
// this header (aligned16, use_device, sm_count) serve every kernel source.
//
// One block owns a BM x BN output tile and walks K in steps of BK. Each step
// stages the x and w slices through shared memory, transposed to k-major so the
// inner product reads contiguous float4s. Two shared-memory stages alternate:
// while the FMAs read one K step, the next step's global loads are in flight into
// registers and then stored to the other stage, so one barrier per step suffices
// and the loads overlap the arithmetic. Each thread keeps an 8 x 8 f32
// accumulator in registers, split as two 4-wide halves in each dimension so that
// the shared-memory float4 reads of a quarter warp are conflict-free. bf16 inputs
// are widened to f32 when staged, so both dtypes share one f32 FFMA main loop, and
// every output sums its K products in k order whatever the tile or staging. Every
// load is masked (rows >= M, columns >= N and k >= K read 0), so any M, N, K is
// covered and the accumulator of a row or column outside the problem is 0.
//
// This loop runs on the FFMA units; the 3xTF32 split (mma_tiles.cuh) keeps f32
// accuracy on the tensor cores, where matmul_stats is to follow matmul_bias_act.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dl4j {

constexpr int kTM = 8;    // accumulator rows per thread
constexpr int kTN = 8;    // accumulator columns per thread
constexpr int kPad = 4;   // keeps float4 alignment of the k-major rows

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Accumulator row i of thread row ty maps to tile row (i < 4 ? ty*4 + i :
// BM/2 + ty*4 + i-4); column j of thread column tx likewise over BN.
template <int BM>
__device__ __forceinline__ int tile_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4);
}
template <int BN>
__device__ __forceinline__ int tile_col(int j, int tx) {
  return j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4);
}

// Stages one (rows x BK) slice of a K-contiguous operand into registers. Load
// e = tid + i * kThreads covers row e / (BK / kW) and columns
// (e % (BK / kW)) * kW + [0, kW), so neighbouring threads read neighbouring k of
// one row. kW = 4 reads float4s: the caller guarantees K % 4 == 0 and 16-byte
// aligned operands, so every float4 is whole and aligned.
template <typename T, int kLoads, int kThreads, int BK, int kW>
__device__ __forceinline__ void load_slice(const T* __restrict__ src, int base,
                                           int limit, int k0, int K, int tid,
                                           float (&dst)[kLoads * kW]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = tid + i * kThreads;
    const int r = base + e / (BK / kW);
    const int k = k0 + (e % (BK / kW)) * kW;
    const bool ok = r < limit && k < K;
    if constexpr (kW == 4) {
      const float4 v = ok ? *reinterpret_cast<const float4*>(
                                src + static_cast<size_t>(r) * K + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[i * 4 + 0] = v.x;
      dst[i * 4 + 1] = v.y;
      dst[i * 4 + 2] = v.z;
      dst[i * 4 + 3] = v.w;
    } else {
      dst[i] = ok ? to_f32(src[static_cast<size_t>(r) * K + k]) : 0.f;
    }
  }
}

// acc[i][j] = sum_k x[row0 + tile_row(i)][k] * w[col0 + tile_col(j)][k], k in
// order. kVec: float32 with K % 4 == 0 and 16-byte aligned x, w (float4 staging).
// Launched with (BM / kTM) * (BN / kTN) threads.
template <typename T, int BM, int BN, int BK, bool kVec>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ x,
                                          const T* __restrict__ w, int M, int N,
                                          int K, int row0, int col0,
                                          float (&acc)[kTM][kTN]) {
  constexpr int kThreads = (BM / kTM) * (BN / kTN);
  constexpr int kW = kVec ? 4 : 1;                    // elements per staged load
  constexpr int kALoads = BM * BK / (kThreads * kW);  // x loads per thread
  constexpr int kBLoads = BN * BK / (kThreads * kW);  // w loads per thread
  static_assert(BM * BK % (kThreads * kW) == 0 && BN * BK % (kThreads * kW) == 0,
                "tile");
  static_assert(!kVec || sizeof(T) == 4, "16-byte staging is float32 only");

  // two stages: the FMAs read one while the next K step is stored to the other
  __shared__ __align__(16) float As[2][BK][BM + kPad];
  __shared__ __align__(16) float Bs[2][BK][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / kTN);
  const int ty = tid / (BN / kTN);

#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float ra[kALoads * kW];
  float rb[kBLoads * kW];

  auto load = [&](int k0) {
    load_slice<T, kALoads, kThreads, BK, kW>(x, row0, M, k0, K, tid, ra);
    load_slice<T, kBLoads, kThreads, BK, kW>(w, col0, N, k0, K, tid, rb);
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int e = tid + i * kThreads;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        As[st][(e % (BK / kW)) * kW + j][e / (BK / kW)] = ra[i * kW + j];
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int e = tid + i * kThreads;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        Bs[st][(e % (BK / kW)) * kW + j][e / (BK / kW)] = rb[i * kW + j];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // global loads in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[kTM];
      float bv[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[stage][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[stage][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[stage][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[stage][kk][BN / 2 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The 128 x 128 tile reuses each staged value 8 times per thread but needs a
// wide N and enough tiles to give every SM a block; otherwise 64 x 64, whose
// 64 threads stage an 8-deep K step to stay within registers.
inline bool wide_tiles(int m, int n, int num_sms) {
  const long tiles128 = static_cast<long>((m + 127) / 128) * ((n + 127) / 128);
  return n > 64 && tiles128 >= num_sms;
}

inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

inline cudaError_t sm_count(int device, int* num_sms) {
  return cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace dl4j
