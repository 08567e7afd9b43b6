// Paged single-token decode attention for Hopper: one query per (row, head)
// against KV caches [B, S, H, D] valid through positions[b] (inclusive).
//
// Replaces the Pallas kernel
// deeplearning4j_tpu/ops/attention.py::_paged_decode_kernel
// (paged_decode_attention), which walks the cache in page-slot blocks along the
// TPU grid's sequential dimension with scalar-prefetched positions, skips the DMA
// and the compute of pages wholly past positions[b], masks the boundary page per
// slot and keeps an online softmax in VMEM scratch.
//
// What bounds it on an H100: a decode step reads every live K and V value once
// and does 4 operations per (slot, d) pair on it, 1 operation per byte in
// float32: far below the card's ridge, so the bytes of the live pages bound it
// (3.35 TB/s). Dead pages are neither read nor computed, so a step costs the
// pages the sequences have filled, not the cache bucket.
//
// Design: one block (4 warps) per (head, batch row) loads positions[b] itself (the
// TPU's scalar prefetch) and loops over the 64-slot pages at or below it. Scores:
// each warp takes slots w, w + 4, ..., its lanes read a slot's contiguous K row
// (coalesced) and form q . k as an f32 sum of products, reduced by an xor
// shuffle. The head size is a compile-time variant (32/64/128/256/512, lanes
// masking d >= D), so a warp issues the loads of 8 slots before their FMAs:
// decode is latency-bound at 96 blocks, and a loop to a runtime head size
// issued each load behind the FMA of the previous one. Slots past
// positions[b] on the boundary page are SET to -1e30 (NEG_INF of the JAX
// package); the scale multiplies the dot product after it is formed. The page's
// max and sum come from shared memory, the running max m and sum l live in
// registers (the same value in every thread), and p stays f32 (the TPU kernel
// does not round it). p . v: thread (g, d) owns output dimension d for the slots
// j = g mod G of each page (G = 128 / D groups), reading V rows coalesced along
// d; the groups' partial sums are added in group order at the end and divided by
// l once. positions[b] >= S attends the whole cache (the TPU kernel's rule).
//
// Only B * H blocks exist (96 at the serving shape): fewer than the 132 SMs, and
// each block streams its pages one after another. Splitting the pages of a row
// over several blocks (flash-decoding) is later work.

#include "ffma_gemm.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPage = 64;
constexpr int kSlotsInFlight = 8;  // slots whose K rows a warp loads at once

// DP: the head size padded to 32, 64, 128, 256 or 512 (lanes mask d >= D).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ positions,
                        T* __restrict__ o, int S, int H, int D, int page,
                        float scale) {
  constexpr int NL = DP / 32;                       // K values per lane per slot
  constexpr bool kNarrow = DP <= kThreads;          // one dimension per thread
  constexpr int kGroups = kNarrow ? kThreads / DP : 1;
  constexpr int NDT = kNarrow ? 1 : DP / kThreads;  // dimensions per thread
  __shared__ float qs[DP];
  __shared__ float ps[kMaxPage];
  __shared__ float red[kThreads];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = kNarrow ? tid / DP : 0;
  const int dd = kNarrow ? tid % DP : tid;

  const long long qrow = (static_cast<long long>(b) * H + h) * D;
  for (int d = tid; d < DP; d += kThreads) {
    qs[d] = d < D ? dl4j::to_f32(q[qrow + d]) : 0.f;
  }
  const int pos = positions[b];
  const int last = min(pos, S - 1);
  const int npages = pos < 0 ? 0 : last / page + 1;
  const long long slot_stride = static_cast<long long>(H) * D;
  const T* kb = kc + static_cast<long long>(b) * S * slot_stride + h * D;
  const T* vb = vc + static_cast<long long>(b) * S * slot_stride + h * D;

  float acc[NDT];
#pragma unroll
  for (int i = 0; i < NDT; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  for (int pg = 0; pg < npages; ++pg) {
    const int s0 = pg * page;
    __syncthreads();  // q staged; the previous page's p consumed
    for (int j0 = warp; j0 < page; j0 += kWarps * kSlotsInFlight) {
      // every load of the kSlotsInFlight slots first, then the FMAs
      float kv[kSlotsInFlight][NL];
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u) {
        const int j = j0 + u * kWarps;
        const T* kr = kb + (s0 + j) * slot_stride;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int d = lane + 32 * i;
          kv[u][i] = (j < page && d < D) ? dl4j::to_f32(kr[d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) part = fmaf(qs[lane + 32 * i], kv[u][i], part);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, w);
        }
        const int j = j0 + u * kWarps;
        if (lane == 0 && j < page) {
          ps[j] = (s0 + j <= pos) ? part * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    float pmax = kNegInf;
    for (int j = 0; j < page; ++j) pmax = fmaxf(pmax, ps[j]);
    const float m_new = fmaxf(m, pmax);
    const float alpha = expf(m - m_new);
    __syncthreads();  // every thread has read the scores
    if (tid < page) ps[tid] = expf(ps[tid] - m_new);
    __syncthreads();
    float psum = 0.f;
    for (int j = 0; j < page; ++j) psum += ps[j];
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < NDT; ++i) acc[i] *= alpha;
    if (g < kGroups) {
#pragma unroll 8
      for (int j = g; j < page; j += kGroups) {
        const T* vr = vb + (s0 + j) * slot_stride;
        const float p = ps[j];
#pragma unroll
        for (int i = 0; i < NDT; ++i) {
          const int d = dd + i * kThreads;
          acc[i] = fmaf(p, d < D ? dl4j::to_f32(vr[d]) : 0.f, acc[i]);
        }
      }
    }
    m = m_new;
  }

  const float linv = l == 0.f ? 1.f : 1.f / l;
  T* orow = o + qrow;
  if (kNarrow) {
    __syncthreads();
    if (g < kGroups) red[g * DP + dd] = acc[0];
    __syncthreads();
    if (tid < D) {
      float total = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) total += red[gg * DP + tid];
      orow[tid] = dl4j::from_f32<T>(total * linv);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NDT; ++i) {
      const int d = dd + i * kThreads;
      if (d < D) orow[d] = dl4j::from_f32<T>(acc[i] * linv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* pos,
                   void* o, int B, int S, int H, int D, int page, float scale,
                   cudaStream_t stream) {
  paged_decode_kernel<T, DP><<<dim3(H, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, static_cast<T*>(o), S, H, D, page, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc,
                     const int* pos, void* o, int B, int S, int H, int D,
                     int page, float scale, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, kc, vc, pos, o, B, S, H, D, page, scale, s);
  if (D <= 64) return launch<T, 64>(q, kc, vc, pos, o, B, S, H, D, page, scale, s);
  if (D <= 128) return launch<T, 128>(q, kc, vc, pos, o, B, S, H, D, page, scale, s);
  if (D <= 256) return launch<T, 256>(q, kc, vc, pos, o, B, S, H, D, page, scale, s);
  if (D <= 512) return launch<T, 512>(q, kc, vc, pos, o, B, S, H, D, page, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,H,D], k_cache/v_cache [B,S,H,D], o [B,H,D], all contiguous in one dtype
// (0 = float32, 1 = bfloat16); positions int32 [B]. page divides S and is at most
// 64; D <= 128 or a multiple of 128 up to 512. Returns a cudaError_t (0 =
// launched); the launch is asynchronous on `stream`.
int dl4j_paged_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                void* o, int B, int S, int H, int D, int page,
                                float scale, int dtype, int device, void* stream) {
  if (B < 0 || H < 0 || S <= 0 || D <= 0 || D > 512 ||
      (D > kThreads && D % kThreads != 0) || page <= 0 || page > kMaxPage ||
      S % page != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const int* pos = static_cast<const int*>(positions);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = dispatch<float>(q, k_cache, v_cache, pos, o, B, S, H, D, page, scale,
                            s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(q, k_cache, v_cache, pos, o, B, S, H, D,
                                    page, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
