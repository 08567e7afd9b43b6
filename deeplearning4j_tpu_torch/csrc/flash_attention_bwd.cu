// Flash attention backward for Hopper: dq, dk and dv of
// o = softmax(scale * q . k^T, masked) . v over [B, H, T, D] operands, from the
// forward's o and row statistics l (sum of exp) and m (row max), and the
// cotangent do.
//
// Replaces the Pallas kernels deeplearning4j_tpu/ops/attention.py::_dq_kernel and
// ::_dkv_kernel (_flash_bwd_impl, the custom VJP of flash_attention). Both
// recompute p = exp(s - m) / l from the scores (l == 0 divides by 1),
// di = rowsum(do . o) in f32 from the stored o, dp = do . v^T and
// ds = p (dp - di) * scale; _dq_kernel sums dq = ds . k over the key blocks of
// the TPU grid's sequential dimension, _dkv_kernel dk = ds^T . q and
// dv = p^T . do over the query blocks, each into VMEM scratch.
//
// What bounds it on an H100: at [8, 12, 1024, 64] causal the dq kernel does 3
// products of 2 B H T^2 D / 2 operations (s, dp, dq) and the dk/dv kernel 4 (s,
// dp, dv, dk) on 9 and 7 [B, H, T, D] operands: about T / 10 operations a byte in
// float32, so operations bound both. f32 stays f32 (no TF32): FFMA kernels, with
// bf16 operands widened to f32 where they are staged.
//
// Design: the TPU's split into two kernels is kept. dq is owned by query rows
// and dk, dv by key rows, so no sum crosses blocks: no atomics, and the result is
// the same from run to run.
// - dq kernel: one block per (query tile, head, batch row). TPR = D / 16 lanes
//   own a query row with its q, do and dq accumulator in registers (16 values of
//   each a lane); a loop over key tiles, staged in shared memory as f32 (K and
//   V), replaces the sequential grid dimension and stops at the causal diagonal
//   of the block's last row. Scores and dp are partial dot products summed by an
//   xor shuffle, so every lane of the row holds them. It computes di from o and
//   do once per row and writes it as a [B, H, Tq] f32 by-product.
// - dk/dv kernel: one block per (key tile, head, batch row). TPR lanes own a key
//   row with its k, v and the dk and dv accumulators in registers; a loop over
//   query tiles from the first one at or below the diagonal down stages q and do
//   of the tile in shared memory as f32, with the rows' m, 1 / l, di and key
//   limit. It reads di from the dq kernel, which runs before it on the same
//   stream: o is then never read by the dk/dv kernel (each key tile would read
//   the query tiles' o again), for 4 bytes a query row (3 MB at the shape above).
// Register pressure: TPR = D / 16 keeps 16 values of each per-row vector a lane
// at every head size, so the dk/dv kernel's two accumulators cost what the
// forward's one does at D = 128 (the padded head size DP = 32 .. 512 gives
// TPR = 2 .. 32). Blocks have 256 threads and own 4096 / DP rows; the two
// staged f32 tiles take 32 KB of static shared memory. chip_smoke.py prints what
// ptxas reports (registers, spills) for every variant.
//
// Rules shared with the forward (flash_common.cuh): masked scores are SET to
// -1e30 (keys past Tk weigh 0); the scale multiplies each f32 dot product after
// it is formed and ds after p (dp - di); ragged Tq and Tk are masked, not padded,
// and queries past Tq contribute nothing to dk and dv. In bf16, p is rounded to
// bf16 before p^T . do and ds before ds . k and ds^T . q, where _dq_kernel and
// _dkv_kernel cast them; products accumulate in f32.
//
// Rows with no valid key (a length-0 feature mask): every score is -1e30, so
// m = -1e30 and p = 1 / l at each key the forward visited (l counts them), and ds
// is not 0. Both kernels weigh exactly the keys the forward visited for the row
// (flash_key_limit) and no others, so every gradient stays finite; it is the JAX
// package's rule, not a true gradient, and such rows are not compared.
//
// A faster backward (wgmma on bf16, TMA-fed double buffering, a persistent
// schedule) is later work.

#include "flash_common.cuh"

namespace {

using dl4j::round_like;
using dl4j::Strides;

// Backward tiles by padded head size DP: TPR lanes a row, 16 values of a row a
// lane (4 float4 chunks: chunk c of lane sl holds d = 4 (sl + TPR c) + e, so the
// TPR lanes of a row read distinct banks), NT threads a block owning S rows, and
// staged tiles of S rows.
template <int DP>
struct BwdCfg {
  static constexpr int TPR = DP / 16;
  static constexpr int NT = 256;
  static constexpr int S = NT / TPR;  // = 4096 / DP
};

template <int TPR, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, bool ok,
                                         int sl, int D, float (&r)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      r[c * 4 + e] = (ok && d < D) ? dl4j::to_f32(src[d]) : 0.f;
    }
  }
}

template <int TPR, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dst, bool ok, int sl,
                                          int D, const float (&r)[16]) {
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      if (d < D) dst[d] = dl4j::from_f32<T>(r[c * 4 + e]);
    }
  }
}

// a lane's 16 values of one staged f32 row
template <int TPR>
__device__ __forceinline__ void chunk(const float* __restrict__ row, int sl,
                                      float (&r)[16]) {
  const float4* t = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 x = t[sl + TPR * c];
    r[c * 4 + 0] = x.x;
    r[c * 4 + 1] = x.y;
    r[c * 4 + 2] = x.z;
    r[c * 4 + 3] = x.w;
  }
}

// the row's dot product: the lanes' partial sums, xor-shuffled across the TPR
// lanes of the row
template <int TPR>
__device__ __forceinline__ float dot(const float (&a)[16], const float (&b)[16]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) part = fmaf(a[i], b[i], part);
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, w);
  }
  return part;
}

__device__ __forceinline__ void axpy(float a, const float (&x)[16],
                                     float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = fmaf(a, x[i], acc[i]);
}

// rows [r0, r0 + S) of one [T, D] operand (row stride st) into shared memory as
// f32, zeros past n rows and past D
template <int DP, int S, int NT, typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, long long st,
                                      int r0, int n, int D, int tid) {
  for (int i = tid; i < S * DP; i += NT) {
    const int j = i / DP, d = i % DP;
    const int r = r0 + j;
    dst[i] = (r < n && d < D) ? dl4j::to_f32(src[static_cast<long long>(r) * st + d])
                              : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<DP>::NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_mask,
                    const T* __restrict__ dout, const T* __restrict__ o,
                    const float* __restrict__ l, const float* __restrict__ m,
                    T* __restrict__ dq, float* __restrict__ di_out, int H, int Tq,
                    int Tk, int D, Strides sq, Strides sk, Strides sv,
                    Strides sdo, int causal, float scale) {
  constexpr int TPR = BwdCfg<DP>::TPR;
  constexpr int S = BwdCfg<DP>::S;
  constexpr int NT = BwdCfg<DP>::NT;
  __shared__ __align__(16) float ks[S * DP];
  __shared__ __align__(16) float vs[S * DP];
  __shared__ float mask_s[S];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int row0 = static_cast<int>(blockIdx.x) * S;
  const int row = row0 + tid / TPR;
  const bool live = row < Tq;
  const int off = Tk - Tq;
  const long long r = (static_cast<long long>(b) * H + h) * Tq + row;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[16], dor[16], acc[16], x[16], y[16];
  load_row<TPR>(q + b * sq.b + h * sq.h + static_cast<long long>(row) * sq.t,
                live, sl, D, qr);
  load_row<TPR>(dout + b * sdo.b + h * sdo.h + static_cast<long long>(row) * sdo.t,
                live, sl, D, dor);
  load_row<TPR>(o + r * D, live, sl, D, x);
  const float di = dot<TPR>(dor, x);  // rowsum(do . o) in f32
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const float mrow = live ? m[r] : 0.f;
  const float lrow = live ? l[r] : 1.f;
  const float linv = lrow == 0.f ? 1.f : 1.f / lrow;
  const int lim = live ? dl4j::flash_key_limit<DP>(row, Tq, Tk, causal) : 0;
  if (live && sl == 0) di_out[r] = di;

  // keys [0, kend): the largest limit of the block's rows, its last live row's
  const int kend = dl4j::flash_key_limit<DP>(min(row0 + S - 1, Tq - 1), Tq, Tk,
                                             causal);
  const int ntiles = (kend + S - 1) / S;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * S;
    __syncthreads();  // the previous tile has been read by every row
    stage<DP, S, NT>(ks, kb, sk.t, k0, Tk, D, tid);
    stage<DP, S, NT>(vs, vb, sv.t, k0, Tk, D, tid);
    for (int j = tid; j < S; j += NT) {
      const int col = k0 + j;
      mask_s[j] = (key_mask != nullptr && col < Tk)
                      ? key_mask[static_cast<long long>(b) * Tk + col]
                      : 1.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < S; ++j) {
      chunk<TPR>(ks + j * DP, sl, x);
      chunk<TPR>(vs + j * DP, sl, y);
      const float s = dot<TPR>(qr, x);
      const float dp = dot<TPR>(dor, y);
      const int col = k0 + j;
      float p = 0.f;
      if (col < lim) {
        p = expf(dl4j::masked_score(s, scale, row, col, Tk, off, causal,
                                    mask_s[j]) - mrow) * linv;
      }
      axpy(round_like<T>(p * (dp - di) * scale), x, acc);
    }
  }
  store_row<TPR>(dq + r * D, live, sl, D, acc);
}

template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<DP>::NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ key_mask,
                     const T* __restrict__ dout, const float* __restrict__ l,
                     const float* __restrict__ m, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                     int Tk, int D, Strides sq, Strides sk, Strides sv,
                     Strides sdo, int causal, float scale) {
  constexpr int TPR = BwdCfg<DP>::TPR;
  constexpr int S = BwdCfg<DP>::S;
  constexpr int NT = BwdCfg<DP>::NT;
  __shared__ __align__(16) float qs[S * DP];
  __shared__ __align__(16) float dos[S * DP];
  __shared__ float m_s[S], linv_s[S], di_s[S];
  __shared__ int lim_s[S];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int col0 = static_cast<int>(blockIdx.x) * S;
  const int col = col0 + tid / TPR;
  const bool live = col < Tk;
  const int off = Tk - Tq;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* db = dout + b * sdo.b + h * sdo.h;

  float kr[16], vr[16], dkr[16], dvr[16], x[16], y[16];
  load_row<TPR>(k + b * sk.b + h * sk.h + static_cast<long long>(col) * sk.t, live,
                sl, D, kr);
  load_row<TPR>(v + b * sv.b + h * sv.h + static_cast<long long>(col) * sv.t, live,
                sl, D, vr);
#pragma unroll
  for (int i = 0; i < 16; ++i) dkr[i] = dvr[i] = 0.f;
  const float kmask =
      (live && key_mask != nullptr) ? key_mask[static_cast<long long>(b) * Tk + col]
                                    : 1.f;

  // the first query tile with a row whose forward visited key col0 (a row's
  // key limit grows with the row)
  const int nq = (Tq + S - 1) / S;
  int i0 = 0;
  while (causal && i0 < nq &&
         dl4j::flash_key_limit<DP>(min(i0 * S + S - 1, Tq - 1), Tq, Tk, causal) <=
             col0) {
    ++i0;
  }
  for (int it = i0; it < nq; ++it) {
    const int r0 = it * S;
    __syncthreads();  // the previous tile has been read by every key row
    stage<DP, S, NT>(qs, qb, sq.t, r0, Tq, D, tid);
    stage<DP, S, NT>(dos, db, sdo.t, r0, Tq, D, tid);
    for (int j = tid; j < S; j += NT) {
      const int row = r0 + j;
      const bool ok = row < Tq;
      const float lv = ok ? l[bh * Tq + row] : 1.f;
      m_s[j] = ok ? m[bh * Tq + row] : 0.f;
      linv_s[j] = lv == 0.f ? 1.f : 1.f / lv;
      di_s[j] = ok ? di[bh * Tq + row] : 0.f;
      lim_s[j] = ok ? dl4j::flash_key_limit<DP>(row, Tq, Tk, causal) : 0;
    }
    __syncthreads();
    // not unrolled: a second copy of x and y would spill (k, v and the two
    // accumulators already hold 64 registers)
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      chunk<TPR>(qs + j * DP, sl, x);
      chunk<TPR>(dos + j * DP, sl, y);
      const float s = dot<TPR>(kr, x);
      const float dp = dot<TPR>(vr, y);
      float p = 0.f;  // rows past Tq have limit 0
      if (col < lim_s[j]) {
        p = expf(dl4j::masked_score(s, scale, r0 + j, col, Tk, off, causal,
                                    kmask) - m_s[j]) * linv_s[j];
      }
      axpy(round_like<T>(p), y, dvr);
      axpy(round_like<T>(p * (dp - di_s[j]) * scale), x, dkr);
    }
  }
  const long long c = bh * Tk + col;
  store_row<TPR>(dk + c * D, live, sl, D, dkr);
  store_row<TPR>(dv + c * D, live, sl, D, dvr);
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *o;
  const float *mask, *l, *m;
  void *dq, *dk, *dv;
  float* di;
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, sdo;
  int causal;
  float scale;
};

template <typename T, int DP>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + BwdCfg<DP>::S - 1) / BwdCfg<DP>::S, a.H, a.B);
  flash_dq_kernel<T, DP><<<grid, BwdCfg<DP>::NT, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      static_cast<const T*>(a.o), a.l, a.m, static_cast<T*>(a.dq), a.di, a.H, a.Tq,
      a.Tk, a.D, a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Tk + BwdCfg<DP>::S - 1) / BwdCfg<DP>::S, a.H, a.B);
  flash_dkv_kernel<T, DP><<<grid, BwdCfg<DP>::NT, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout), a.l, a.m,
      a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Tq, a.Tk, a.D,
      a.sq, a.sk, a.sv, a.sdo, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.D <= 32) return kDq ? launch_dq<T, 32>(a, s) : launch_dkv<T, 32>(a, s);
  if (a.D <= 64) return kDq ? launch_dq<T, 64>(a, s) : launch_dkv<T, 64>(a, s);
  if (a.D <= 128) return kDq ? launch_dq<T, 128>(a, s) : launch_dkv<T, 128>(a, s);
  if (a.D <= 256) return kDq ? launch_dq<T, 256>(a, s) : launch_dkv<T, 256>(a, s);
  if (a.D <= 512) return kDq ? launch_dq<T, 512>(a, s) : launch_dkv<T, 512>(a, s);
  return cudaErrorInvalidValue;
}

template <bool kDq>
int run(const BwdArgs& a, int dtype, int device, void* stream) {
  if (a.B < 0 || a.H < 0 || a.Tq < 0 || a.Tk < 0 || a.D <= 0 || a.D > 512 ||
      a.H > 65535 || a.B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.B == 0 || a.H == 0 || a.Tq == 0 || a.Tk == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float, kDq>(a, s));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16, kDq>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, do [B,H,Tq,D] and k, v [B,H,Tk,D] with element strides (b, h, t) and unit D
// stride; key_mask: float32 [B, Tk] (contiguous) or null; o [B,H,Tq,D] and dq
// contiguous in the input dtype; l, m, di [B,H,Tq] float32 contiguous (di is
// written). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 =
// launched); the launch is asynchronous on `stream`.
int dl4j_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* key_mask, const void* dout,
                                const void* o, const void* l, const void* m,
                                void* dq, void* di, int B, int H, int Tq, int Tk,
                                int D, long long q_sb, long long q_sh,
                                long long q_st, long long k_sb, long long k_sh,
                                long long k_st, long long v_sb, long long v_sh,
                                long long v_st, long long do_sb, long long do_sh,
                                long long do_st, int causal, float scale,
                                int dtype, int device, void* stream) {
  BwdArgs a{q, k, v, dout, o,
            static_cast<const float*>(key_mask), static_cast<const float*>(l),
            static_cast<const float*>(m), dq, nullptr, nullptr,
            static_cast<float*>(di), B, H, Tq, Tk, D,
            Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
            Strides{v_sb, v_sh, v_st}, Strides{do_sb, do_sh, do_st}, causal,
            scale};
  return run<true>(a, dtype, device, stream);
}

// As above, after dl4j_flash_attention_bwd_dq on the same stream: reads its di;
// dk, dv [B,H,Tk,D] contiguous in the input dtype are written.
int dl4j_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* l, const void* m, const void* di,
                                 void* dk, void* dv, int B, int H, int Tq, int Tk,
                                 int D, long long q_sb, long long q_sh,
                                 long long q_st, long long k_sb, long long k_sh,
                                 long long k_st, long long v_sb, long long v_sh,
                                 long long v_st, long long do_sb, long long do_sh,
                                 long long do_st, int causal, float scale,
                                 int dtype, int device, void* stream) {
  BwdArgs a{q, k, v, dout, nullptr,
            static_cast<const float*>(key_mask), static_cast<const float*>(l),
            static_cast<const float*>(m), nullptr, dk, dv,
            const_cast<float*>(static_cast<const float*>(di)), B, H, Tq, Tk, D,
            Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
            Strides{v_sb, v_sh, v_st}, Strides{do_sb, do_sh, do_st}, causal,
            scale};
  return run<false>(a, dtype, device, stream);
}

}  // extern "C"
