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
// N = 64..2048, M = batch * H * W) are those of matmul_bias_act: operation-bound
// except the K = N = 64 shape, which moves more bytes than it computes.
// float32 stays f32 accurate on the tensor cores through the 3xTF32 split
// (165 TFLOP/s, against 67 for FFMA); bfloat16 runs bf16 MMAs with f32
// accumulation. The statistics add 2 FLOPs per output and write only
// [M / BM, N] partials.
//
// Design: the tensor-core main loop of tc_gemm.cuh with matmul_bias_act's tiles.
// The tensor cores round every accumulation toward zero, which biases each |y|
// low, and sum(y^2) by twice as much: summed straight, float32's sum(y^2) sits
// at 0.9-1.2 of the 1e-5 of sum(y^2) the statistics are held to at K = 512 and
// at 1.9-4.6 of it at K >= 1024, in an emulation of the arithmetic at
// ResNet-50's shapes (tests/test_torch_stats_decode_split.py). So float32 sums
// each 32-deep K step fresh where K > 256 (tc_gemm.cuh's kFresh), which bounds
// the bias by that of 32-term sums (0.12 of the tolerance at most), and
// straight at K <= 256 (0.51 of it at most), where it is not needed and its
// extra fragment makes the 128 x 64 tile spill (255 registers; PERF.md has
// the card's times of both). bfloat16
// sums straight: its y is rounded to 8 bits. K is a layer's input width, so
// a row's result still does not depend on the batch. The epilogue works on
// the m16n8 accumulator fragments, where lane (g, t) holds rows g and g + 8 of
// each 16-row fragment and columns 2t, 2t + 1 of each 8-column one: it rounds
// each value to the storage dtype, stores y two columns a lane (a quad writes
// 32 contiguous bytes of a row) and keeps the rounded value; each lane sums its
// rows per column, an xor shuffle over the g bits of the lane (offsets 4, 8,
// 16) sums a warp's rows, and the warps that share a column add up in shared
// memory in a fixed order. Block b writes row b of the partials; the wrapper
// sums the partials over b. No float atomics: every order of addition is
// fixed, so the statistics are the same bits from run to run. Rows >= M add
// nothing and columns >= N are not written, so any M, N, K is covered.
//
// Tiles: 128 x 64 (4 warps of 64 x 32) where the problem has two such tiles for
// each SM (tc::wide_tiles), else 64 x 64 (4 warps of 32 x 32); block_m below is
// the one rule both the launch and dl4j_matmul_stats_block_m (the partials'
// height) take.

#include <atomic>
#include <cstdint>

#include "ffma_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

namespace mma = dl4j::mma;
namespace tc = dl4j::tc;

constexpr int kStraightMaxK = 256;  // float32 sums K steps fresh above it

// the tile height BM for an (m, n) problem: the partials have ceil(m / BM) rows
inline int block_m(int m, int n, int num_sms) {
  return tc::wide_tiles(m, n, num_sms) ? 128 : 64;
}

template <typename T, int BM, int BN, int WM, int WN, bool kFresh>
__global__ void __launch_bounds__(tc::Gemm<T, BM, BN, WM, WN>::NT)
    tc_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ s_part,
                    float* __restrict__ q_part, int M, int N, int K, int vec,
                    int pairs) {
  using G = tc::Gemm<T, BM, BN, WM, WN>;
  constexpr int kWarpsM = BM / WM;  // warps that share a column
  static_assert(G::NT >= BN, "one thread a column for the block's sums");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_s[kWarpsM][BN];
  __shared__ float red_q[kWarpsM][BN];

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[G::MT][G::NTL][4];
  tc::gemm_tile<G, kFresh>(x, w, M, N, K, row0, col0, vec != 0,
                           reinterpret_cast<T*>(smem), acc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;
  const int t = lane & 3;
  const int r0 = row0 + wm * WM + (lane >> 2);
  const int cw = wn * WN;  // the warp's first column in the tile

  // 1. round to the storage dtype (the statistics are over the stored y),
  // store, and keep the rounded value; rows >= M hold 0 from here on
#pragma unroll
  for (int nt = 0; nt < G::NTL; ++nt) {
    const int c = col0 + cw + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + mt * 16 + 8 * half;
        float& v0 = acc[mt][nt][2 * half];
        float& v1 = acc[mt][nt][2 * half + 1];
        if (r < M) {
          T* yp = y + static_cast<size_t>(r) * N + c;
          if (pairs && c + 1 < N) {
            mma::store2(yp, v0, v1);
          } else {
            if (c < N) mma::store1(yp, v0);
            if (c + 1 < N) mma::store1(yp + 1, v1);
          }
          v0 = dl4j::to_f32(dl4j::from_f32<T>(v0));
          v1 = dl4j::to_f32(dl4j::from_f32<T>(v1));
        } else {
          v0 = 0.f;
          v1 = 0.f;
        }
      }
    }
  }

  // 2. column sums: the lane's 2 * MT rows, then the warp's 8 row groups
  // (xor over the g bits), then the warps that share the column, in order
#pragma unroll
  for (int nt = 0; nt < G::NTL; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
      float q = 0.f;
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[mt][nt][2 * half + e];
          s += v;
          q = fmaf(v, v, q);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane < 4) {
        red_s[wm][cw + nt * 8 + 2 * t + e] = s;
        red_q[wm][cw + nt * 8 + 2 * t + e] = q;
      }
    }
  }
  __syncthreads();
  if (tid < BN && col0 + tid < N) {
    float s = 0.f;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < kWarpsM; ++v) {
      s += red_s[v][tid];
      q += red_q[v][tid];
    }
    const size_t at = static_cast<size_t>(blockIdx.x) * N + col0 + tid;
    s_part[at] = s;
    q_part[at] = q;
  }
}

template <typename T, int BM, int BN, int WM, int WN, bool kFresh>
cudaError_t launch(const void* x, const void* w, void* y, float* s_part,
                   float* q_part, int m, int n, int k, int device,
                   cudaStream_t stream) {
  using G = tc::Gemm<T, BM, BN, WM, WN>;
  auto* const kernel = tc_stats_kernel<T, BM, BN, WM, WN, kFresh>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = mma::allow_smem(kernel, G::kSmem, device, done);
  if (err != cudaSuccess) return err;
  // 16-byte rows for cp.async; 2-element stores where y's rows keep them aligned
  const bool vec = dl4j::aligned16(x) && dl4j::aligned16(w) &&
                   (static_cast<long long>(k) * sizeof(T)) % 16 == 0;
  const bool pairs = n % 2 == 0 &&
                     reinterpret_cast<std::uintptr_t>(y) % (2 * sizeof(T)) == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kernel<<<grid, G::NT, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      s_part, q_part, m, n, k, vec ? 1 : 0, pairs ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, bool kFresh>
cudaError_t dispatch(const void* x, const void* w, void* y, float* s_part,
                     float* q_part, int m, int n, int k, int bm, int device,
                     cudaStream_t stream) {
  return bm == 128
             ? launch<T, 128, 64, 64, 32, kFresh>(x, w, y, s_part, q_part, m,
                                                  n, k, device, stream)
             : launch<T, 64, 64, 32, 32, kFresh>(x, w, y, s_part, q_part, m,
                                                 n, k, device, stream);
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
  return block_m(m, n, num_sms);
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
  const int bm = block_m(m, n, num_sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(s_part);
  float* qp = static_cast<float*>(q_part);
  switch (dtype) {
    case 0:
      err = k > kStraightMaxK
                ? dispatch<float, true>(x, w, y, sp, qp, m, n, k, bm, device, s)
                : dispatch<float, false>(x, w, y, sp, qp, m, n, k, bm, device,
                                         s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16, false>(x, w, y, sp, qp, m, n, k, bm,
                                           device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
