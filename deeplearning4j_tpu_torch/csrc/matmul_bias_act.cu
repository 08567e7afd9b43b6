// Dense / 1x1-convolution forward for Hopper: y[M,N] = act(x[M,K] . w[N,K]^T + b[N]).
//
// Replaces the Pallas kernel deeplearning4j_tpu/kernels/impls.py::matmul_bias_act
// (_mm_bias_act_kernel), which tiles the same product on the TPU's matrix unit with
// an f32 VMEM accumulator and runs bias + activation in the last K block.
//
// What bounds it on an H100: at the ResNet-50 serving shapes (K = 64..2048,
// N = 64..2048, M = batch * H * W) the problems are operation-bound except the
// K = N = 64 shape, which moves more bytes than it computes. float32 stays f32
// accurate on the tensor cores through the 3xTF32 split (three TF32 MMAs a
// product: 495 / 3 = 165 TFLOP/s, against 67 for FFMA, the rate of any f32
// kernel off the tensor cores); bfloat16 runs bf16 MMAs with f32 accumulation.
//
// Design: the tensor-core main loop of tc_gemm.cuh (BM x BN block tiles of
// m16n8 warp fragments, a 3-stage cp.async ring over K steps of 32, each f32
// fragment split in registers) and an epilogue that adds the bias and applies
// the activation on the f32 accumulator; the store rounds once to the input
// dtype, two neighbouring columns a lane, so a quad writes 32 contiguous bytes
// (one whole memory sector) of a row. Loads are zero-filled and stores masked,
// so any M, N, K is covered (the TPU kernel needed tiles that divide the
// problem).
//
// Tiles: 128 x 64 (4 warps of 64 x 32) or 64 x 64 (4 warps of 32 x 32), the
// caller's choice (the registry's tuned tiling), or by default 128 x 64 where the
// problem has two such tiles for each SM (tc::wide_tiles), else 64 x 64. Both sum
// each output in the same order, so the output is the same bits under either
// tile, and a row's output does not depend on the batch it is served in.
//
// Accumulation: float32 sums straight (one accumulator per output) up to
// K = kStraightMaxK, ResNet-50's largest K, and each 32-deep K step fresh
// above it (tc_gemm.cuh's kFresh): the tensor cores round every accumulation
// toward zero, and straight sums over SimpleCNN's K = 9216 drifted to 0.996 of
// the 1e-4 + 1e-4 |y| tolerance (LeNet's K = 2450 and AlexNet's 6400 sit
// between). bfloat16 sums straight: its tolerance is 80 times wider.

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "activations.cuh"
#include "ffma_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

using dl4j::apply_act;
using dl4j::kNumActs;
namespace mma = dl4j::mma;
namespace tc = dl4j::tc;

constexpr int kStraightMaxK = 2048;  // float32 sums K steps fresh above it

// the bias and activation of a warp's fragments, stored as T. ACT: the
// activation id when it is known at compile time, else -1 (act at run time)
template <int ACT, typename T, typename G>
__device__ __forceinline__ void store_tile(const float (&acc)[G::MT][G::NTL][4],
                                           const T* __restrict__ b,
                                           T* __restrict__ y, int M, int N,
                                           int r0, int c0, int act, bool pairs,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < G::NTL; ++nt) {
    const int c = c0 + nt * 8 + 2 * t;
    const float b0 = c < N ? dl4j::to_f32(b[c]) : 0.f;
    const float b1 = c + 1 < N ? dl4j::to_f32(b[c + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + mt * 16 + 8 * half;
        if (r >= M) continue;
        T* yp = y + static_cast<size_t>(r) * N + c;
        const float z0 = apply_act(ACT < 0 ? act : ACT, acc[mt][nt][2 * half] + b0);
        const float z1 =
            apply_act(ACT < 0 ? act : ACT, acc[mt][nt][2 * half + 1] + b1);
        if (pairs && c + 1 < N) {
          mma::store2(yp, z0, z1);
        } else {
          if (c < N) mma::store1(yp, z0);
          if (c + 1 < N) mma::store1(yp + 1, z1);
        }
      }
    }
  }
}

template <typename T, int BM, int BN, int WM, int WN, bool kFresh>
__global__ void __launch_bounds__(tc::Gemm<T, BM, BN, WM, WN>::NT)
    mm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, int M, int N,
                       int K, int act, int vec, int pairs) {
  using G = tc::Gemm<T, BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * G::BM;
  const int col0 = blockIdx.y * G::BN;
  float acc[G::MT][G::NTL][4];
  tc::gemm_tile<G, kFresh>(x, w, M, N, K, row0, col0, vec != 0,
                           reinterpret_cast<T*>(smem), acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + (warp / G::kWarpsN) * G::WM + (lane >> 2);
  const int c0 = col0 + (warp % G::kWarpsN) * G::WN;
  // identity and relu (the 1x1 convolutions' activations) inlined; any other
  // activation through the run-time switch: the switch inlined at each of a
  // thread's outputs made the whole kernel several times slower at small K
  switch (act) {
    case 0:
      store_tile<0, T, G>(acc, b, y, M, N, r0, c0, act, pairs != 0, lane & 3);
      break;
    case 3:
      store_tile<3, T, G>(acc, b, y, M, N, r0, c0, act, pairs != 0, lane & 3);
      break;
    default:
      store_tile<-1, T, G>(acc, b, y, M, N, r0, c0, act, pairs != 0, lane & 3);
  }
}

template <typename T, int BM, int BN, int WM, int WN, bool kFresh>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int m,
                   int n, int k, int act, int device, cudaStream_t stream) {
  using G = tc::Gemm<T, BM, BN, WM, WN>;
  auto* const kernel = mm_bias_act_kernel<T, BM, BN, WM, WN, kFresh>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = mma::allow_smem(kernel, G::kSmem, device, done);
  if (err != cudaSuccess) return err;
  // 16-byte rows for cp.async; 2-element stores where y's rows keep them aligned
  const bool vec = dl4j::aligned16(x) && dl4j::aligned16(w) &&
                   (static_cast<long long>(k) * sizeof(T)) % 16 == 0;
  const bool pairs = n % 2 == 0 &&
                     reinterpret_cast<std::uintptr_t>(y) % (2 * sizeof(T)) == 0;
  const dim3 grid((m + G::BM - 1) / G::BM, (n + G::BN - 1) / G::BN);
  kernel<<<grid, G::NT, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), m, n, k, act, vec ? 1 : 0, pairs ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, bool kFresh>
cudaError_t dispatch_tiles(const void* x, const void* w, const void* b, void* y,
                           int m, int n, int k, int act, bool wide, int device,
                           cudaStream_t stream) {
  return wide ? launch<T, 128, 64, 64, 32, kFresh>(x, w, b, y, m, n, k, act,
                                                   device, stream)
              : launch<T, 64, 64, 32, 32, kFresh>(x, w, b, y, m, n, k, act,
                                                  device, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y, int m,
                     int n, int k, int act, bool wide, int device,
                     cudaStream_t stream) {
  if (std::is_same<T, float>::value && k > kStraightMaxK) {
    return dispatch_tiles<T, true>(x, w, b, y, m, n, k, act, wide, device,
                                   stream);
  }
  return dispatch_tiles<T, false>(x, w, b, y, m, n, k, act, wide, device,
                                  stream);
}

__global__ void probe_kernel(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1.f;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: an id of apply_act. (bm, bn): the
// block tile, (128, 64) or (64, 64), or (0, 0) for the default rule
// (tc::wide_tiles). Returns a cudaError_t (0 = launched); the launch is
// asynchronous on `stream`.
int dl4j_matmul_bias_act(const void* x, const void* w, const void* b, void* y,
                         int m, int n, int k, int dtype, int act, int bm, int bn,
                         int device, void* stream) {
  const bool chosen = bm != 0 || bn != 0;
  if (m < 0 || n < 0 || k < 0 || act < 0 || act >= kNumActs ||
      (chosen && !((bm == 128 || bm == 64) && bn == 64))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  bool wide = bm == 128;
  if (!chosen) {
    int num_sms = 0;
    err = dl4j::sm_count(device, &num_sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide = tc::wide_tiles(m, n, num_sms);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = dispatch<float>(x, w, b, y, m, n, k, act, wide, device, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(x, w, b, y, m, n, k, act, wide, device, s);
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
