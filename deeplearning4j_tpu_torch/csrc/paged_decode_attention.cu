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
// pages the sequences have filled, not the cache bucket. The card reaches that
// rate only with some 20 KB in flight on every SM: the design is about keeping
// the bytes of many pages in flight at once.
//
// Design: split-KV on thread-block clusters. A cluster of 8 blocks (4 warps
// each) serves one (head, row): grid (8, H, B), 768 blocks at the serving shape
// (8 rows x 12 heads) where one block a (head, row) gave 96 for 132 SMs. The
// live pages of a row are cut into chunks of 1024 / DP slots (16 at D = 64; at
// least one a warp), and cluster rank r takes the row's live chunks r, r + 8,
// r + 16, ...; the split depends on positions[b] only (never on B or on the
// cache bucket), so a row's output is the same bits in every batch it is
// decoded in. A rank copies the K and V rows of its chunks together into a
// 2-stage shared-memory ring with 16-byte cp.async (a slot's head is D
// contiguous values at stride H * D), so the next chunk's bytes are in flight
// while this one is computed. Chunks rather than whole pages spread a short
// row over the ranks (a one-page row keeps 4 of them busy at D = 64, not one),
// and stages this small (16 KB a block in f32) keep every block of the launch
// resident at once (PERF.md has the card's numbers for the alternatives).
// Scores: warp w takes the chunk's slots w, w + 4, ..., its lanes read a slot's
// K row from shared memory and form q . k as an f32 sum of products, reduced by
// an xor shuffle, then times the scale; slots past positions[b] on the boundary
// page are SET to -1e30 (NEG_INF of the JAX package; the page is read whole).
// The chunk's max and sum: every warp reduces all the chunk's scores by warp
// shuffles from one shared-memory copy (no serial loop, no second barrier) and
// keeps its own copy of p, which stays f32 (the TPU kernel does not round it).
// p . v: thread (g, d) owns output dimension d for the chunk's slots
// j = g mod G (G = 128 / D groups), reading V rows along d; the groups' sums
// are added in group order at the end. Each rank then writes its running max m,
// sum l and unnormalised o[D] to its own shared memory; after cluster.sync(),
// rank 0 reads the 8 partials through distributed shared memory in rank order
// and combines them (M = max m_i, L = sum l_i e^(m_i - M),
// o = sum o_i e^(m_i - M) / L), then stores o rounded once. A rank with no live
// chunk contributes m = -1e30, l = 0, o = 0. One launch, no workspace in device
// memory, no counters. positions[b] >= S attends the whole cache (the TPU
// kernel's rule); a negative position gives zeros.

#include <cooperative_groups.h>

#include <atomic>

#include "ffma_gemm.cuh"
#include "mma_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
namespace mma = dl4j::mma;

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRanks = 8;  // blocks of a cluster: the split of a row's pages
constexpr int kMaxPage = 64;
constexpr int kStageElems = 1024;  // elements of one operand's stage
constexpr int kStages = 2;           // the cp.async ring

// DP: the head size padded to 32, 64, 128, 256 or 512 (lanes mask d >= D).
template <typename T, int DP>
struct DecodeCfg {
  // slots a chunk at most: kStageElems / DP, at least a slot a warp
  static constexpr int CH =
      kStageElems / DP < kWarps     ? kWarps
      : kStageElems / DP < kMaxPage ? kStageElems / DP
                                    : kMaxPage;
  static constexpr int kOperand = CH * DP;   // elements of K (or V) a stage
  static constexpr int kStage = 2 * kOperand;  // K rows, then V rows
  static constexpr int NL = DP / 32;           // q and K values a lane
  static constexpr int PL = (CH + 31) / 32;    // scores a lane
  static constexpr bool kNarrow = DP <= kThreads;
  static constexpr int kGroups = kNarrow ? kThreads / DP : 1;
  static constexpr int NDT = kNarrow ? 1 : DP / kThreads;  // dims a thread
};

template <typename T, int DP>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
    cluster_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ positions, T* __restrict__ o,
                          int S, int H, int D, int page, int chunk, int cpp,
                          float scale, int vec) {
  using C = DecodeCfg<T, DP>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ps[C::CH];              // the chunk's scores
  __shared__ float pw[kWarps][C::CH];      // each warp's copy of p
  __shared__ float red[C::kGroups][DP];    // the groups' sums of o
  __shared__ float part[DP + 2];           // this rank's o[DP], m, l

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = C::kNarrow ? tid / DP : 0;
  const int dd = C::kNarrow ? tid % DP : tid;
  T* const ring = reinterpret_cast<T*>(smem);

  const long long qrow = (static_cast<long long>(b) * H + h) * D;
  float qv[C::NL];
#pragma unroll
  for (int i = 0; i < C::NL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? dl4j::to_f32(q[qrow + d]) : 0.f;
  }
  const int pos = positions[b];
  const int npages = pos < 0 ? 0 : min(pos, S - 1) / page + 1;
  const int live = npages * cpp;  // the row's live chunks
  const int nc = rank < live ? (live - 1 - rank) / kRanks + 1 : 0;
  const long long st = static_cast<long long>(H) * D;
  const T* kb = kc + static_cast<long long>(b) * S * st + static_cast<long long>(h) * D;
  const T* vb = vc + static_cast<long long>(b) * S * st + static_cast<long long>(h) * D;

  // chunk c of this rank: the row's chunk rank + 8 * c, slots [s0, s1)
  auto bounds = [&](int c, int& s0, int& s1) {
    const int gc = rank + kRanks * c;
    const int pg = gc / cpp;
    s0 = pg * page + (gc % cpp) * chunk;
    s1 = min(s0 + chunk, (pg + 1) * page);
  };
  auto load = [&](int c) {  // K and V rows of chunk c, rows past s1 zero-filled
    int s0, s1;
    bounds(c, s0, s1);
    T* dst = ring + (c % kStages) * C::kStage;
    mma::load_tile<T, C::CH, DP, DP, kThreads>(dst, kb, st, s0, s1, D, vec != 0,
                                               tid);
    mma::load_tile<T, C::CH, DP, DP, kThreads>(dst + C::kOperand, vb, st, s0,
                                               s1, D, vec != 0, tid);
  };

  float acc[C::NDT];
#pragma unroll
  for (int i = 0; i < C::NDT; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nc) load(i);
    mma::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    mma::cp_async_wait<kStages - 2>();  // chunk c (one group per chunk)
    __syncthreads();  // ... everyone's; every thread is done with c - 1
    if (c + kStages - 1 < nc) load(c + kStages - 1);  // into c - 1's stage
    mma::cp_async_commit();
    int s0, s1;
    bounds(c, s0, s1);
    const T* ks = ring + (c % kStages) * C::kStage;
    const T* vs = ks + C::kOperand;

    // scores of the chunk's slots: warp w takes w, w + 4, ...
#pragma unroll
    for (int u = 0; u < C::CH / kWarps; ++u) {
      const int j = warp + u * kWarps;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < C::NL; ++i) {
        dot = fmaf(qv[i], dl4j::to_f32(ks[j * DP + lane + 32 * i]), dot);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (lane == 0) ps[j] = (s0 + j < s1 && s0 + j <= pos) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // the chunk's max and sum, reduced by every warp alike; p kept per warp
    float sc[C::PL];
    float cmax = kNegInf;
#pragma unroll
    for (int u = 0; u < C::PL; ++u) {
      const int j = lane + 32 * u;
      sc[u] = j < C::CH ? ps[j] : kNegInf;
      cmax = fmaxf(cmax, sc[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    }
    const float m_new = fmaxf(m, cmax);
    float csum = 0.f;
#pragma unroll
    for (int u = 0; u < C::PL; ++u) {
      const int j = lane + 32 * u;
      const float p = expf(sc[u] - m_new);
      if (j < C::CH) pw[warp][j] = p;
      csum += j < C::CH ? p : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      csum += __shfl_xor_sync(0xffffffffu, csum, off);
    }
    __syncwarp();
    const float alpha = expf(m - m_new);
    l = l * alpha + csum;
    m = m_new;

    // p . v over the staged V rows (rows past s1 are zeros, their p is 0)
#pragma unroll
    for (int i = 0; i < C::NDT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < C::CH / C::kGroups; ++u) {
      const int j = g + u * C::kGroups;
      const float p = pw[warp][j];
#pragma unroll
      for (int i = 0; i < C::NDT; ++i) {
        acc[i] = fmaf(p, dl4j::to_f32(vs[j * DP + dd + i * kThreads]), acc[i]);
      }
    }
  }

  // this rank's partial (o unnormalised, m, l) in its shared memory
  if constexpr (C::kNarrow) {
    red[g][dd] = acc[0];
    __syncthreads();
    if (tid < DP) {
      float total = 0.f;
#pragma unroll
      for (int gg = 0; gg < C::kGroups; ++gg) total += red[gg][tid];
      part[tid] = total;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::NDT; ++i) part[dd + i * kThreads] = acc[i];
  }
  if (tid == 0) {
    part[DP] = m;
    part[DP + 1] = l;
  }
  cluster.sync();

  // rank 0 combines the ranks' partials in rank order
  if (rank == 0) {
    const float* parts[kRanks];
    float mi[kRanks];
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kRanks; ++r) {
      parts[r] = cluster.map_shared_rank(part, r);
      mi[r] = parts[r][DP];
      mx = fmaxf(mx, mi[r]);
    }
    float total_l = 0.f;
#pragma unroll
    for (int r = 0; r < kRanks; ++r) {
      mi[r] = expf(mi[r] - mx);  // the rank's weight
      total_l += parts[r][DP + 1] * mi[r];
    }
    const float linv = total_l == 0.f ? 1.f : 1.f / total_l;
    for (int d = tid; d < D; d += kThreads) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < kRanks; ++r) total += parts[r][d] * mi[r];
      o[qrow + d] = dl4j::from_f32<T>(total * linv);
    }
  }
  cluster.sync();  // every rank's shared memory stays until rank 0 has read it
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* pos,
                   void* o, int B, int S, int H, int D, int page, float scale,
                   int device, cudaStream_t stream) {
  using C = DecodeCfg<T, DP>;
  const int cpp = (page + C::CH - 1) / C::CH;  // chunks a page
  const int chunk = (page + cpp - 1) / cpp;    // slots a chunk
  const int bytes = kStages * C::kStage * static_cast<int>(sizeof(T));
  auto* const kernel = cluster_decode_kernel<T, DP>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = mma::allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  // 16-byte cp.async where every slot's head starts 16-byte aligned
  const bool vec = dl4j::aligned16(kc) && dl4j::aligned16(vc) &&
                   (static_cast<long long>(D) * sizeof(T)) % 16 == 0;
  kernel<<<dim3(kRanks, H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, static_cast<T*>(o), S, H, D, page, chunk,
      cpp, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc,
                     const int* pos, void* o, int B, int S, int H, int D,
                     int page, float scale, int device, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, kc, vc, pos, o, B, S, H, D, page, scale, device, s);
  if (D <= 64) return launch<T, 64>(q, kc, vc, pos, o, B, S, H, D, page, scale, device, s);
  if (D <= 128) return launch<T, 128>(q, kc, vc, pos, o, B, S, H, D, page, scale, device, s);
  if (D <= 256) return launch<T, 256>(q, kc, vc, pos, o, B, S, H, D, page, scale, device, s);
  if (D <= 512) return launch<T, 512>(q, kc, vc, pos, o, B, S, H, D, page, scale, device, s);
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
      err = dispatch<float>(q, k_cache, v_cache, pos, o, B, S, H, D, page,
                            scale, device, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(q, k_cache, v_cache, pos, o, B, S, H, D,
                                    page, scale, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
