// Dense / 1x1-convolution forward for Hopper: y[M,N] = act(x[M,K] . w[N,K]^T + b[N]).
//
// Replaces the Pallas kernel deeplearning4j_tpu/kernels/impls.py::matmul_bias_act
// (_mm_bias_act_kernel), which tiles the same product on the TPU's matrix unit with
// an f32 VMEM accumulator and runs bias + activation in the last K block.
//
// What bounds it on an H100: at the ResNet-50 serving shapes (K = 64..2048,
// N = 64..2048, M = batch * H * W) the f32 problems sit near the FFMA ridge:
// the K = N = 64 shape moves more bytes than it computes (bytes-bound), the
// others are operation-bound on the 67 TFLOP/s FFMA rate. f32 must stay f32 (no
// TF32), so the tensor cores are out for f32 and this kernel is an FFMA kernel.
//
// Design: the FFMA main loop of ffma_gemm.cuh (BM x BN block tiles, two
// shared-memory stages, an 8 x 8 f32 accumulator per thread, k-order sums) and
// an epilogue that adds the bias and applies the activation on the f32
// accumulator; the store rounds once to the input dtype, and a warp's stores
// cover 256 contiguous bytes. Every load and store is masked, so any M, N, K is
// covered (the TPU kernel needed tiles that divide the problem).
//
// Variants: float32 problems with K and N multiples of 4 (all ResNet-50 shapes)
// load 16-byte float4s, and store them from 128 x 128 tiles. A 128 x 128 tile (256
// threads, 16-deep K step) is capped at 128 registers so two blocks share an SM;
// problems with too few such tiles to give each of the 132 SMs one take 64 x 64
// tiles (64 threads, 8-deep K step).
//
// A faster kernel (wgmma on bf16, TMA, a persistent schedule) is later work.

#include <type_traits>

#include "activations.cuh"
#include "ffma_gemm.cuh"

namespace {

using dl4j::apply_act;
using dl4j::kNumActs;
using dl4j::kTM;
using dl4j::kTN;

// kVec: float32 with K % 4 == 0, N % 4 == 0 and 16-byte aligned x, w, y —
// staged as float4s, and stored as float4s from the 128 x 128 tiles.
template <typename T, int BM, int BN, int BK, bool kVec>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), BM == 128 ? 2 : 1)
    mm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, int M, int N,
                       int K, int act) {
  const int tx = threadIdx.x % (BN / kTN);
  const int ty = threadIdx.x / (BN / kTN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[kTM][kTN];
  dl4j::gemm_tile<T, BM, BN, BK, kVec>(x, w, M, N, K, row0, col0, acc);

  float bias[kTN];
  int cols[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    cols[j] = col0 + dl4j::tile_col<BN>(j, tx);
    bias[j] = cols[j] < N ? dl4j::to_f32(b[cols[j]]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + dl4j::tile_row<BM>(i, ty);
    if (r >= M) continue;
    T* yrow = y + static_cast<size_t>(r) * N;
    float z[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) z[j] = apply_act(act, acc[i][j] + bias[j]);
    if constexpr (kVec && BM == 128) {
      // N % 4 == 0: a 4-column group is either wholly inside N or wholly out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cols[h * 4] < N) {
          *reinterpret_cast<float4*>(yrow + cols[h * 4]) =
              make_float4(z[h * 4], z[h * 4 + 1], z[h * 4 + 2], z[h * 4 + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (cols[j] < N) yrow[cols[j]] = dl4j::from_f32<T>(z[j]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, bool kVec>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int m,
                   int n, int k, int act, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const dim3 block((BM / kTM) * (BN / kTN));
  mm_bias_act_kernel<T, BM, BN, BK, kVec><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), m, n, k, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y, int m,
                     int n, int k, int act, int num_sms, cudaStream_t stream) {
  const bool wide = dl4j::wide_tiles(m, n, num_sms);
  if constexpr (std::is_same<T, float>::value) {
    if (k % 4 == 0 && n % 4 == 0 && dl4j::aligned16(x) && dl4j::aligned16(w) &&
        dl4j::aligned16(y)) {
      return wide ? launch<T, 128, 128, 16, true>(x, w, b, y, m, n, k, act, stream)
                  : launch<T, 64, 64, 8, true>(x, w, b, y, m, n, k, act, stream);
    }
  }
  return wide ? launch<T, 128, 128, 16, false>(x, w, b, y, m, n, k, act, stream)
              : launch<T, 64, 64, 8, false>(x, w, b, y, m, n, k, act, stream);
}

__global__ void probe_kernel(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1.f;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: an id of apply_act. Returns a
// cudaError_t (0 = launched); the launch is asynchronous on `stream`.
int dl4j_matmul_bias_act(const void* x, const void* w, const void* b, void* y,
                         int m, int n, int k, int dtype, int act, int device,
                         void* stream) {
  if (m < 0 || n < 0 || k < 0 || act < 0 || act >= kNumActs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  int num_sms = 0;
  err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = dispatch<float>(x, w, b, y, m, n, k, act, num_sms, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(x, w, b, y, m, n, k, act, num_sms, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The capability probe: x[i] += 1 over n float32 values.
int dl4j_probe(void* x, int n, int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
