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
// Design: one block owns a BM x BN output tile and walks K in steps of BK.
// Each step stages the x and w slices through shared memory, transposed to
// k-major so the inner product reads contiguous float4s. Two shared-memory
// stages alternate: while the FMAs read one K step, the next step's global loads
// are in flight into registers and then stored to the other stage, so one
// barrier per step suffices and the loads overlap the arithmetic. Each thread
// keeps an 8 x 8 f32 accumulator in registers, split as two 4-wide halves in
// each dimension so that the shared-memory float4 reads of a quarter warp are
// conflict-free and a warp's stores cover 256 contiguous bytes. Bias and the
// activation run in the epilogue on the f32 accumulator; the store rounds once
// to the input dtype. bf16 inputs are widened to f32 when staged, so both dtypes
// share one f32 FFMA main loop, and every output sums its K products in k order
// whatever the tile or staging. Every load and store is masked, so any M, N, K
// is covered (the TPU kernel needed tiles that divide the problem).
//
// Variants: float32 problems with K and N multiples of 4 (all ResNet-50 shapes)
// load 16-byte float4s, and store them from 128 x 128 tiles. A 128 x 128 tile (256
// threads, 16-deep K step) is capped at 128 registers so two blocks share an SM;
// problems with too few such tiles to give each of the 132 SMs one take 64 x 64
// tiles (64 threads, 8-deep K step).
//
// A faster kernel (wgmma on bf16, TMA, a persistent schedule) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

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

__device__ __forceinline__ float softplus_f(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

// The ids are the port's ACTIVATION_IDS table (kernels/impls.py); a test holds
// the two tables equal. Every formula is the one conf/activations.py applies.
__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case 0:  // identity
      return z;
    case 1:  // sigmoid
      return 1.f / (1.f + expf(-z));
    case 2:  // tanh
      return tanhf(z);
    case 3:  // relu
      return fmaxf(z, 0.f);
    case 4:  // relu6
      return fminf(fmaxf(z, 0.f), 6.f);
    case 5:  // leakyrelu
      return z >= 0.f ? z : 0.01f * z;
    case 6:  // elu
      return z > 0.f ? z : expm1f(z);
    case 7:  // selu
      return 1.0507009873554805f * (z > 0.f ? z : 1.6732632423543772f * expm1f(z));
    case 8: {  // gelu (tanh approximation)
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.f + tanhf(u));
    }
    case 9:  // softplus
      return softplus_f(z);
    case 10:  // softsign
      return z / (1.f + fabsf(z));
    case 11:  // swish
      return z / (1.f + expf(-z));
    case 12:  // mish
      return z * tanhf(softplus_f(z));
    case 13:  // hardsigmoid
      return fminf(fmaxf(0.2f * z + 0.5f, 0.f), 1.f);
    case 14:  // hardtanh
      return fminf(fmaxf(z, -1.f), 1.f);
    case 15:  // cube
      return z * z * z;
    case 16: {  // rationaltanh
      const float y = 2.f * z / 3.f;
      const float a = fabsf(y);
      const float s = (y > 0.f) ? 1.f : ((y < 0.f) ? -1.f : 0.f);
      return 1.7159f * s * (1.f - 1.f / (1.f + a + y * y + 1.41645f * (y * y * y * y)));
    }
    case 17:  // rectifiedtanh
      return fmaxf(tanhf(z), 0.f);
    case 18:  // thresholdedrelu
      return z > 1.f ? z : 0.f;
    default:
      return z;
  }
}
constexpr int kNumActs = 19;

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

// kVec: float32 with K % 4 == 0, N % 4 == 0 and 16-byte aligned x, w, y —
// staged as float4s, and stored as float4s from the 128 x 128 tiles.
template <typename T, int BM, int BN, int BK, bool kVec>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), BM == 128 ? 2 : 1)
    mm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ y, int M, int N,
                       int K, int act) {
  constexpr int kThreads = (BM / kTM) * (BN / kTN);
  constexpr int kW = kVec ? 4 : 1;                // elements per staged load
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
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[kTM][kTN];
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

  // Epilogue: thread row i maps to tile row (i < 4 ? ty*4 + i : BM/2 + ty*4 + i-4),
  // column j likewise over BN.
  float bias[kTN];
  int cols[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    cols[j] = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
    bias[j] = cols[j] < N ? to_f32(b[cols[j]]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
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
        if (cols[j] < N) yrow[cols[j]] = from_f32<T>(z[j]);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y, int m,
                     int n, int k, int act, int num_sms, cudaStream_t stream) {
  // The 128 x 128 tile reuses each staged value 8 times per thread but needs a
  // wide N and enough tiles to give every SM a block; otherwise 64 x 64, whose
  // 64 threads stage an 8-deep K step to stay within registers.
  const long tiles128 = static_cast<long>((m + 127) / 128) * ((n + 127) / 128);
  const bool wide = n > 64 && tiles128 >= num_sms;
  if constexpr (std::is_same<T, float>::value) {
    if (k % 4 == 0 && n % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(y)) {
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

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
