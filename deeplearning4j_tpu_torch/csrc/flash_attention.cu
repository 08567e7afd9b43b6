// Flash attention forward for Hopper: o = softmax(scale * q . k^T, masked) . v over
// [B, H, T, D] operands, with the row statistics l (sum of exp) and m (row max).
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/attention.py::_fwd_kernel
// (_flash_fwd_impl / flash_attention), which walks key blocks in the TPU grid's
// sequential innermost dimension with the running max, sum and output kept in
// VMEM scratch, skips key blocks above the causal diagonal and stores o, l, m.
//
// What bounds it on an H100: the prompt prefill (T up to 1024, D = 64) does
// 4 * B * H * Tq * Tk * D * (1/2 causal) operations on 4 * B * H * T * D values,
// about T / 4 operations per byte in float32, so operations bound it at every
// prompt longer than a few dozen tokens. f32 stays f32 (no TF32), so this is an
// FFMA kernel; bf16 operands are widened to f32 when staged.
//
// Design: one block per (64-row query tile, head, batch row); a loop inside the
// block replaces the TPU's sequential grid dimension. Each query row is owned by
// TPR consecutive lanes of a warp, each holding DP / TPR of the row's q values and
// of its f32 output accumulator in registers; the lanes' partial dot products are
// summed by an xor shuffle, so every lane of the row holds the row's scores, and
// the running max m and sum l stay in registers (no cross-row reduction at all).
// A lane owns the float4 chunks sl, sl + TPR, sl + 2 TPR, ... of the row, so the
// TPR lanes of a row read distinct banks of a shared-memory K or V row. K and V
// tiles are staged through shared memory as f32, read by every row of the block.
// The loop stops at the causal diagonal of the block's last row; the key mask
// (float, tested > 0) and the causal rule col <= row + (Tk - Tq) SET masked scores
// to -1e30 (NEG_INF of the JAX package, so a fully masked row stays finite), and
// keys past Tk (the ragged last tile, which the TPU kernel padded instead) score
// -inf and weigh exactly 0. The scale multiplies each f32 dot product after it is
// formed. In bf16, p is rounded to bf16 before the p . v product, as the TPU
// kernel casts it to v's dtype; l sums the unrounded p. o is divided by l once at
// the end (l == 0, a row with no key visited, divides by 1).
//
// Variants by padded head size DP (D <= DP, the lanes mask d >= D): 32, 64 and 128
// with 64-row tiles; 256 and 512 with 32-row tiles. The key tile BK keeps both
// staged tiles at 32 KB or less of static shared memory. The tiles, the mask rule
// and the keys visited are in flash_common.cuh, which the backward kernels
// (flash_attention_bwd.cu) share.
//
// A faster kernel (wgmma on bf16, TMA-fed double buffering, a persistent
// schedule over tiles) is later work.

#include "flash_common.cuh"

namespace {

using dl4j::FlashCfg;
using dl4j::kNegInf;
using dl4j::round_like;
using dl4j::Strides;

template <typename T, int DP>
__global__ void __launch_bounds__(FlashCfg<DP>::BQ * FlashCfg<DP>::TPR)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ key_mask,
                     T* __restrict__ o, float* __restrict__ l_out,
                     float* __restrict__ m_out, int H, int Tq, int Tk, int D,
                     Strides sq, Strides sk, Strides sv, int causal, float scale) {
  constexpr int TPR = FlashCfg<DP>::TPR;
  constexpr int BQ = FlashCfg<DP>::BQ;
  constexpr int BK = FlashCfg<DP>::BK;
  constexpr int NT = BQ * TPR;
  constexpr int DPT = DP / TPR;  // values of a row per lane
  constexpr int NC = DPT / 4;    // float4 chunks per lane
  __shared__ __align__(16) float ks[BK * DP];
  __shared__ __align__(16) float vs[BK * DP];
  __shared__ float mask_s[BK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sl = tid % TPR;
  const int row0 = static_cast<int>(blockIdx.x) * BQ;
  const int row = row0 + tid / TPR;
  const int off = Tk - Tq;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (sl + TPR * c) * 4 + e;
      qr[c * 4 + e] = (row < Tq && d < D)
                          ? dl4j::to_f32(qb[static_cast<long long>(row) * sq.t + d])
                          : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // keys [0, kend): the causal diagonal of the block's last row bounds them
  const int kend = dl4j::flash_key_limit<DP>(row0, Tq, Tk, causal);
  const int ntiles = (kend + BK - 1) / BK;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile has been read by every row
    for (int i = tid; i < BK * DP; i += NT) {
      const int j = i / DP, d = i % DP;
      const int col = k0 + j;
      const bool ok = col < Tk && d < D;
      ks[i] = ok ? dl4j::to_f32(kb[static_cast<long long>(col) * sk.t + d]) : 0.f;
      vs[i] = ok ? dl4j::to_f32(vb[static_cast<long long>(col) * sv.t + d]) : 0.f;
    }
    for (int j = tid; j < BK; j += NT) {
      const int col = k0 + j;
      mask_s[j] = (key_mask != nullptr && col < Tk)
                      ? key_mask[static_cast<long long>(b) * Tk + col]
                      : 1.f;
    }
    __syncthreads();

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DP);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[sl + TPR * c];
        part = fmaf(qr[c * 4 + 0], kk.x, part);
        part = fmaf(qr[c * 4 + 1], kk.y, part);
        part = fmaf(qr[c * 4 + 2], kk.z, part);
        part = fmaf(qr[c * 4 + 3], kk.w, part);
      }
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, w);
      }
      const float sc = dl4j::masked_score(part, scale, row, k0 + j, Tk, off,
                                          causal, mask_s[j]);
      s[j] = sc;
      tmax = fmaxf(tmax, sc);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pv = round_like<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DP);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[sl + TPR * c];
        acc[c * 4 + 0] = fmaf(pv, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(pv, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(pv, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(pv, vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (row < Tq) {
    const long long r = (static_cast<long long>(b) * H + h) * Tq + row;
    const float linv = l == 0.f ? 1.f : 1.f / l;
    T* orow = o + r * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (sl + TPR * c) * 4 + e;
        if (d < D) orow[d] = dl4j::from_f32<T>(acc[c * 4 + e] * linv);
      }
    }
    if (sl == 0) {
      l_out[r] = l;
      m_out[r] = m;
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                   void* o, float* l, float* m, int B, int H, int Tq, int Tk, int D,
                   Strides sq, Strides sk, Strides sv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int BQ = FlashCfg<DP>::BQ;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DP><<<grid, BQ * FlashCfg<DP>::TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), l, m, H, Tq, Tk, D, sq, sk, sv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* mask,
                     void* o, float* l, float* m, int B, int H, int Tq, int Tk,
                     int D, Strides sq, Strides sk, Strides sv, int causal,
                     float scale, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  if (D <= 64) return launch<T, 64>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  if (D <= 128) return launch<T, 128>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  if (D <= 256) return launch<T, 256>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  if (D <= 512) return launch<T, 512>(q, k, v, mask, o, l, m, B, H, Tq, Tk, D, sq, sk, sv, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] with element strides (b, h, t) and unit D stride;
// key_mask: float32 [B, Tk] (contiguous) or null; o [B,H,Tq,D] contiguous in the
// input dtype; l, m [B,H,Tq] float32. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = launched); the launch is asynchronous on `stream`.
int dl4j_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_mask, void* o, void* l, void* m,
                             int B, int H, int Tq, int Tk, int D,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             int causal, float scale, int dtype, int device,
                             void* stream) {
  if (B < 0 || H < 0 || Tq < 0 || Tk < 0 || D <= 0 || D > 512 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dl4j::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  const Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, sv{v_sb, v_sh, v_st};
  const float* mask = static_cast<const float*>(key_mask);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = dispatch<float>(q, k, v, mask, o, lp, mp, B, H, Tq, Tk, D, sq, sk, sv,
                            causal, scale, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(q, k, v, mask, o, lp, mp, B, H, Tq, Tk, D, sq,
                                    sk, sv, causal, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
