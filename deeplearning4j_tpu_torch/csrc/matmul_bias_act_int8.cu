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
// QuantizedConv1x1Layer) the integer dot products bound it.
//
// Design (a simple kernel that is exact; tensor cores are later work):
// - __dp4a: 4 consecutive k of a row of xq are one 32-bit word as stored. In wq they
//   are N bytes apart, so each thread reads a 4 x 4 byte block of the staged wq
//   slice (4 rows k, 4 columns n) as 4 words and transposes it in registers with
//   __byte_perm into one word of 4 k per column. wq keeps the contract layout.
// - Tiles: a block of 64 threads owns BM rows x 64 columns; BM is 8, 16 or 32, the
//   smallest that covers M up to 32, so at every serving bucket one row tile holds
//   the whole batch and each weight byte is read once. Thread (tx, ty) owns
//   columns 4 tx + [0, 4) and rows ty + 4 i, so a warp's two row groups read
//   neighbouring shared-memory rows (different banks).
// - Staging: a 4-deep ring of 64-deep K slices in shared memory, filled by 16-byte
//   cp.async copies (K and N multiples of 16, 16-byte aligned operands) or, for
//   ragged shapes, by masked byte loads. Everything outside the problem stages 0.
// - Split K: when the output tiles would give the card fewer than 3 blocks per SM
//   (the serving shapes have 64 tiles), the K range splits into S chunks of whole
//   slices. Each block writes its int32 sums to a [S, M, N] workspace and a second
//   kernel adds the S partials (integers: exact in any order) and runs the epilogue.
// - Exact sums: |acc| <= 128 * 128 * K < 2^31 for K < 131072 (the wrapper checks).
// - Epilogue: int32 -> f32 with __int2float_rn, then __fmul_rn and __fadd_rn, so
//   scale and bias round twice as in the plain version and the JAX package (nvcc
//   would contract them into one FMA); then the activation of activations.cuh.

#include <cstdint>

#include "activations.cuh"
#include "ffma_gemm.cuh"

namespace {

using dl4j::apply_act;
using dl4j::kNumActs;

constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 64;          // k per staged slice
constexpr int kStages = 4;       // slices in the shared-memory ring
constexpr int kThreads = 64;     // 16 column quads x 4 row groups
constexpr int kMinChunk = 512;   // k per split, at least
constexpr int kBlocksPerSm = 3;  // split K until the grid has this many per SM

__device__ __forceinline__ float epilogue(int acc, float scale, float bias, int act) {
  return apply_act(act, __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias));
}

// 16 bytes global -> shared; ok = false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages k in [k0, k0 + kBK) of rows [m0, m0 + BM) of x and columns [n0, n0 + kBN)
// of w; 0 outside the problem and at k >= kend. kVec: K, N and kend are multiples
// of 16 and x, w 16-byte aligned, so every 16-byte piece is wholly in or out.
template <int BM, bool kVec>
__device__ __forceinline__ void load_slice(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int8_t (*xs)[kBK], int8_t (*ws)[kBN], int M,
                                           int N, int K, int m0, int n0, int k0,
                                           int kend) {
  if constexpr (kVec) {
    for (int p = threadIdx.x; p < BM * (kBK / 16); p += kThreads) {
      const int r = p / (kBK / 16), c = (p % (kBK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < kend;
      cp_async16(&xs[r][c], ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, ok);
    }
    for (int p = threadIdx.x; p < kBK * (kBN / 16); p += kThreads) {
      const int r = p / (kBN / 16), c = (p % (kBN / 16)) * 16;
      const bool ok = k0 + r < kend && n0 + c < N;
      cp_async16(&ws[r][c], ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w, ok);
    }
  } else {
    for (int p = threadIdx.x; p < BM * kBK; p += kThreads) {
      const int r = p / kBK, c = p % kBK;
      const bool ok = m0 + r < M && k0 + c < kend;
      xs[r][c] = ok ? x[static_cast<size_t>(m0 + r) * K + k0 + c] : int8_t{0};
    }
    for (int p = threadIdx.x; p < kBK * kBN; p += kThreads) {
      const int r = p / kBN, c = p % kBN;
      const bool ok = k0 + r < kend && n0 + c < N;
      ws[r][c] = ok ? w[static_cast<size_t>(k0 + r) * N + n0 + c] : int8_t{0};
    }
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows [BM x, BM x + BM), columns
// [64 y, 64 y + 64), k in [chunk z, chunk z + chunk). kSplit: int32 sums into
// part[z] instead of the epilogue into y.
template <int BM, bool kVec, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    mm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ b,
                   float* __restrict__ y, int* __restrict__ part, int M, int N, int K,
                   int chunk, int act) {
  constexpr int RM = BM / 4;  // rows per thread
  __shared__ __align__(16) int8_t xs[kStages][BM][kBK];
  __shared__ __align__(16) int8_t ws[kStages][kBK][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(K, kbeg + chunk);
  const int nk = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  int acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_slice<BM, kVec>(x, w, xs[s], ws[s], M, N, K, m0, n0, kbeg + s * kBK, kend);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // slice t has landed
    __syncthreads();               // ... for every thread, and slot t - 1 is free
    const int next = t + kStages - 1;
    if (next < nk) {
      load_slice<BM, kVec>(x, w, xs[next % kStages], ws[next % kStages], M, N, K, m0,
                           n0, kbeg + next * kBK, kend);
    }
    cp_async_commit();
    const uint32_t* wv = reinterpret_cast<const uint32_t*>(&ws[t % kStages][0][0]);
    const int* xv = reinterpret_cast<const int*>(&xs[t % kStages][0][0]);
#pragma unroll 4
    for (int q = 0; q < kBK / 4; ++q) {
      // rows 4q .. 4q+3 of columns 4tx .. 4tx+3, one word per row
      const uint32_t r0 = wv[(4 * q + 0) * (kBN / 4) + tx];
      const uint32_t r1 = wv[(4 * q + 1) * (kBN / 4) + tx];
      const uint32_t r2 = wv[(4 * q + 2) * (kBN / 4) + tx];
      const uint32_t r3 = wv[(4 * q + 3) * (kBN / 4) + tx];
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      int col[4];  // col[j]: k = 4q .. 4q+3 of column 4tx + j
      col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
      col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
      col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
      col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int a = xv[(4 * i + ty) * (kBK / 4) + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, col[j], acc[i][j]);
      }
    }
  }

  const int n = n0 + 4 * tx;
  const bool vec = (N % 4 == 0) && n + 3 < N;  // 16-byte row pieces, wholly inside
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + 4 * i + ty;
    if (m >= M) continue;
    const size_t o = static_cast<size_t>(m) * N + n;
    if constexpr (kSplit) {
      int* dst = part + static_cast<size_t>(blockIdx.z) * M * N + o;
      if (vec) {
        *reinterpret_cast<int4*>(dst) = make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < N) dst[j] = acc[i][j];
        }
      }
    } else {
      float z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z[j] = n + j < N ? epilogue(acc[i][j], scale[n + j], b[n + j], act) : 0.f;
      }
      if (vec) {
        *reinterpret_cast<float4*>(y + o) = make_float4(z[0], z[1], z[2], z[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < N) y[o + j] = z[j];
        }
      }
    }
  }
}

// y = epilogue(sum over the S partials): the second pass of a split-K launch.
__global__ void splitk_epilogue_kernel(const int* __restrict__ part, int splits,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ b, float* __restrict__ y,
                                       int M, int N, int act) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += part[s * total + o];
    const int n = static_cast<int>(o % N);
    y[o] = epilogue(acc, scale[n], b[n], act);
  }
}

int block_m(int m) { return m <= 8 ? 8 : (m <= 16 ? 16 : 32); }

// The K chunk of one split: a multiple of kBK, at least kMinChunk unless K is
// smaller, and small enough that the grid gives every SM kBlocksPerSm blocks.
int split_chunk(int m, int n, int k, int num_sms) {
  const int bm = block_m(m);
  const long tiles = static_cast<long>((m + bm - 1) / bm) * ((n + kBN - 1) / kBN);
  const long want = (static_cast<long>(kBlocksPerSm) * num_sms + tiles - 1) / tiles;
  const long most = k / kMinChunk > 1 ? k / kMinChunk : 1;
  const long splits = want < most ? (want > 1 ? want : 1) : most;
  long chunk = (k + splits - 1) / splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  return static_cast<int>(chunk > kBK ? chunk : kBK);
}

int num_splits(int k, int chunk) { return k > chunk ? (k + chunk - 1) / chunk : 1; }

template <int BM, bool kVec>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale, const float* b,
                   float* y, int* part, int m, int n, int k, int chunk, int splits,
                   int act, int num_sms, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + kBN - 1) / kBN, splits);
  if (splits == 1) {
    mm_int8_kernel<BM, kVec, false>
        <<<grid, kThreads, 0, stream>>>(x, w, scale, b, y, part, m, n, k, chunk, act);
    return cudaGetLastError();
  }
  mm_int8_kernel<BM, kVec, true>
      <<<grid, kThreads, 0, stream>>>(x, w, scale, b, y, part, m, n, k, chunk, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = static_cast<long>(m) * n;
  const long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 8L * num_sms ? want : 8L * num_sms);
  splitk_epilogue_kernel<<<blocks, 256, 0, stream>>>(part, splits, scale, b, y, m, n, act);
  return cudaGetLastError();
}

template <int BM>
cudaError_t dispatch_vec(bool vec, const int8_t* x, const int8_t* w, const float* scale,
                         const float* b, float* y, int* part, int m, int n, int k,
                         int chunk, int splits, int act, int num_sms,
                         cudaStream_t stream) {
  return vec ? launch<BM, true>(x, w, scale, b, y, part, m, n, k, chunk, splits, act,
                                num_sms, stream)
             : launch<BM, false>(x, w, scale, b, y, part, m, n, k, chunk, splits, act,
                                 num_sms, stream);
}

}  // namespace

extern "C" {

// The number of K splits the kernel takes for an (m, n, k) problem on `device`:
// 1, or S > 1 and the caller passes an int32 workspace of S * m * n. A negative
// value is a negated cudaError_t.
int dl4j_matmul_int8_splits(int m, int n, int k, int device) {
  if (m <= 0 || n <= 0 || k < 0) return 1;
  int num_sms = 0;
  const cudaError_t err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return num_splits(k, split_chunk(m, n, k, num_sms));
}

// x [m, k] int8, w [k, n] int8, scale and b [n] float32, y [m, n] float32; work:
// the int32 [S, m, n] workspace when dl4j_matmul_int8_splits returned S > 1 (else
// unused). act: an id of apply_act. Returns a cudaError_t (0 = launched); the
// launches are asynchronous on `stream`.
int dl4j_matmul_bias_act_int8(const void* x, const void* w, const void* scale,
                              const void* b, void* y, void* work, int m, int n, int k,
                              int act, int device, void* stream) {
  if (m < 0 || n < 0 || k < 0 || act < 0 || act >= kNumActs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  int num_sms = 0;
  err = dl4j::sm_count(device, &num_sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = split_chunk(m, n, k, num_sms);
  const int splits = num_splits(k, chunk);
  if (splits > 1 && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 16 == 0 && n % 16 == 0 && dl4j::aligned16(x) && dl4j::aligned16(w);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<float*>(y);
  auto* pp = static_cast<int*>(work);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_m(m)) {
    case 8:
      err = dispatch_vec<8>(vec, xp, wp, sp, bp, yp, pp, m, n, k, chunk, splits, act,
                            num_sms, s);
      break;
    case 16:
      err = dispatch_vec<16>(vec, xp, wp, sp, bp, yp, pp, m, n, k, chunk, splits, act,
                             num_sms, s);
      break;
    default:
      err = dispatch_vec<32>(vec, xp, wp, sp, bp, yp, pp, m, n, k, chunk, splits, act,
                             num_sms, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
