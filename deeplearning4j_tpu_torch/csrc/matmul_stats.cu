// Fused 1x1-convolution + batch-norm statistics for Hopper:
// y[M,N] = x[M,K] . w[N,K]^T, plus per-column sum(y) and sum(y*y) in f32.
//
// Replaces the Pallas kernels deeplearning4j_tpu/kernels/impls.py::matmul_stats
// (_mm_stats_kernel) and deeplearning4j_tpu/ops/conv_fused.py::matmul_with_stats
// (_kernel), which compute the same function: the last K block rounds the f32
// accumulator to the storage dtype, stores y, and sums the ROUNDED y and y^2 down
// each column of the block into [row blocks, N] partials, reduced afterwards.
// Taking the statistics in the epilogue saves the pass that would read y back.
//
// What bounds it on an H100: the ResNet-50 training shapes (K = 64..2048,
// N = 64..2048, M = batch * H * W) are those of matmul_bias_act: f32 products
// near the FFMA ridge, operation-bound on the 67 TFLOP/s FFMA rate except the
// K = N = 64 shape, which is bytes-bound. The statistics add 2 FLOPs per output
// and write only [M / BM, N] partials.
//
// Design: the FFMA main loop of ffma_gemm.cuh, then an epilogue that rounds each
// accumulator to the storage dtype in place, stores y, and reduces the rounded
// values column by column: each thread sums its 8 rows, a warp shuffle (xor over
// the lanes that share a column) sums a warp's rows, and shared memory sums the
// warps in a fixed order. Block b writes row b of the partials; the wrapper sums
// the partials over b. No float atomics: every order of addition is fixed, so the
// statistics are the same bits from run to run. Rows >= M add nothing and columns
// >= N are not written, so any M, N, K is covered.
//
// Variants and tiles are matmul_bias_act's (128 x 128 tiles capped at 128
// registers, 64 x 64 tiles when there are too few wide tiles for the 132 SMs;
// float4 staging and stores for float32 with K and N multiples of 4).

#include <type_traits>

#include "ffma_gemm.cuh"

namespace {

using dl4j::kTM;
using dl4j::kTN;

template <typename T, int BM, int BN, int BK, bool kVec>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), BM == 128 ? 2 : 1)
    mm_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ s_part,
                    float* __restrict__ q_part, int M, int N, int K) {
  constexpr int kThreads = (BM / kTM) * (BN / kTN);
  constexpr int kWarps = kThreads / 32;
  constexpr int kTX = BN / kTN;  // threads across a tile row; lanes tx, tx + kTX, ...
  static_assert(kThreads % 32 == 0 && 32 % kTX == 0 && kThreads >= BN, "tile");
  __shared__ float red_s[kWarps][BN];
  __shared__ float red_q[kWarps][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[kTM][kTN];
  dl4j::gemm_tile<T, BM, BN, BK, kVec>(x, w, M, N, K, row0, col0, acc);

  int cols[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) cols[j] = col0 + dl4j::tile_col<BN>(j, tx);

  // round to the storage dtype (the statistics are over the stored y) and store
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + dl4j::tile_row<BM>(i, ty);
    T yv[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      yv[j] = dl4j::from_f32<T>(acc[i][j]);
      // rows >= M hold 0 (masked loads); keep them out of the sums regardless
      acc[i][j] = r < M ? dl4j::to_f32(yv[j]) : 0.f;
    }
    if (r >= M) continue;
    T* yrow = y + static_cast<size_t>(r) * N;
    if constexpr (kVec && BM == 128) {
      // N % 4 == 0: a 4-column group is either wholly inside N or wholly out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cols[h * 4] < N) {
          *reinterpret_cast<float4*>(yrow + cols[h * 4]) = make_float4(
              acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (cols[j] < N) yrow[cols[j]] = yv[j];
      }
    }
  }

  // column sums: this thread's 8 rows, then the warp's lanes that share the
  // column (xor over lane bits >= kTX), then the warps in order
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float s = 0.f;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      s += acc[i][j];
      q = fmaf(acc[i][j], acc[i][j], q);
    }
#pragma unroll
    for (int off = kTX; off < 32; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane < kTX) {
      red_s[warp][dl4j::tile_col<BN>(j, tx)] = s;
      red_q[warp][dl4j::tile_col<BN>(j, tx)] = q;
    }
  }
  __syncthreads();
  if (tid < BN && col0 + tid < N) {
    float s = 0.f;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      s += red_s[v][tid];
      q += red_q[v][tid];
    }
    const size_t at = static_cast<size_t>(blockIdx.x) * N + col0 + tid;
    s_part[at] = s;
    q_part[at] = q;
  }
}

template <typename T, int BM, int BN, int BK, bool kVec>
cudaError_t launch(const void* x, const void* w, void* y, float* s_part,
                   float* q_part, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const dim3 block((BM / kTM) * (BN / kTN));
  mm_stats_kernel<T, BM, BN, BK, kVec><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      s_part, q_part, m, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, float* s_part,
                     float* q_part, int m, int n, int k, bool wide,
                     cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (k % 4 == 0 && n % 4 == 0 && dl4j::aligned16(x) && dl4j::aligned16(w) &&
        dl4j::aligned16(y)) {
      return wide ? launch<T, 128, 128, 16, true>(x, w, y, s_part, q_part, m, n, k, stream)
                  : launch<T, 64, 64, 8, true>(x, w, y, s_part, q_part, m, n, k, stream);
    }
  }
  return wide ? launch<T, 128, 128, 16, false>(x, w, y, s_part, q_part, m, n, k, stream)
              : launch<T, 64, 64, 8, false>(x, w, y, s_part, q_part, m, n, k, stream);
}

}  // namespace

extern "C" {

// The row-block height BM the kernel takes for an (m, n) problem on `device`:
// the partials have ceil(m / BM) rows. Returns 128 or 64, or -cudaError_t.
int dl4j_matmul_stats_block_m(int m, int n, int device) {
  if (m < 0 || n < 0) return -static_cast<int>(cudaErrorInvalidValue);
  int num_sms = 0;
  const cudaError_t err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dl4j::wide_tiles(m, n, num_sms) ? 128 : 64;
}

// dtype: 0 = float32, 1 = bfloat16. y [m, n] in the input dtype; s_part and
// q_part [ceil(m / block_m), n] float32, block_m from dl4j_matmul_stats_block_m.
// Returns a cudaError_t (0 = launched); the launch is asynchronous on `stream`.
int dl4j_matmul_stats(const void* x, const void* w, void* y, void* s_part,
                      void* q_part, int m, int n, int k, int dtype, int device,
                      void* stream) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  int num_sms = 0;
  err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide = dl4j::wide_tiles(m, n, num_sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(s_part);
  float* qp = static_cast<float*>(q_part);
  switch (dtype) {
    case 0:
      err = dispatch<float>(x, w, y, sp, qp, m, n, k, wide, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(x, w, y, sp, qp, m, n, k, wide, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
