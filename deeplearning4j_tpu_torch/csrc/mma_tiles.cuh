// Warp-level tensor-core building blocks for Hopper (sm_90a) with f32 accuracy
// where the operands are f32: the 3xTF32 split, the mma.sync wrappers, the
// fragment loads from padded shared-memory tiles, and the cp.async staging of
// [rows, D] operand tiles.
//
// csrc/flash_attention.cu (the forward), csrc/flash_attention_bwd.cu (dq and
// dk/dv) and csrc/tc_gemm.cuh (the GEMM main loop) include it.
//
// Fragments follow PTX's mma.sync layouts (g = lane / 4, t = lane % 4):
// - m16n8k8 tf32: A (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4); B (8 x 8, col) b0 (k t, n g), b1 (k t + 4, n g).
// - m16n8k16 bf16: A a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//   a3 (g + 8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).
// - the f32 accumulator (16 x 8): c0, c1 (g, 2t and 2t+1), c2, c3 (g + 8, ...).
//
// An accumulator tile feeds the next product as its A operand without a
// shuffle. bf16: columns 2t, 2t+1 of two neighbouring n-tiles are exactly a0..a3
// of one k16 chunk. tf32: the k order of a product is free, so k slot t of the
// A fragment takes the accumulator's column 2t and slot t + 4 its column 2t + 1,
// and the B fragment is read with the same permutation (rows 2t and 2t + 1 of
// the k chunk, mma_ckn below).
//
// The 3xTF32 split: big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and
// a . b ~ small_a . big_b + big_a . small_b + big_a . big_b, accumulated in f32
// (the small terms first). Dropping small . small leaves about 2**-22 of each
// product, where one TF32 product keeps about 11 bits.
//
// Shared tiles are row-major with LD = DP + 16 / sizeof(T) elements a row: the
// row stride is 4 words modulo 32 (20 for bf16 at DP = 32), so each fragment
// load below (8 rows x 4 words, or 4 rows 2 apart x 8 words, or ldmatrix's 8
// rows of 16 bytes) hits 32 distinct banks, and every row starts 16-byte
// aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace dl4j {
namespace mma {

// the row stride LD of a shared tile of DP columns of T
template <typename T>
constexpr int tile_ld(int dp) {
  return dp + 16 / static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from global to shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a [n, D] operand (row stride st elements, unit D
// stride) into a shared tile of row stride LD, columns [0, DP): 16-byte
// cp.async chunks where `vec` (16-byte aligned base and strides) and the chunk
// lies inside D, rows past n zero-filled by the copy; columns past D are
// stored as zeros, and a chunk that straddles D (or any chunk when !vec) is
// loaded element by element. The caller commits the group and waits for it.
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long st, int r0, int n, int D,
                                          bool vec, int tid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int CPR = DP / E;                          // chunks a row
  static_assert((ROWS * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = tid + it * NT;
    const int j = i / CPR, c = (i % CPR) * E;
    const int r = r0 + j;
    const bool row_ok = r < n;
    T* d = dst + j * LD + c;
    if (vec && c + E <= D) {
      cp_async16(d, row_ok ? src + static_cast<long long>(r) * st + c : src,
                 row_ok);
    } else if (c >= D) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        d[e] = (row_ok && c + e < D) ? src[static_cast<long long>(r) * st + c + e]
                                     : T{};
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the 3xTF32 split and the MMA instructions
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 of a finite x (round to nearest, ties away from zero, at 13
// dropped mantissa bits) in two integer operations. Every element of every
// float32 operand goes through it twice, and on an H100 the instruction made
// the flash backward kernels 1.4-1.6x slower.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// Splits a shared f32 tile of ROWS x DP (row stride LD) in place: big
// overwrites x, small goes to the same place of `small`. Staged B tiles are
// split once for the 4 warps that read them.
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void split_tile(float* __restrict__ big,
                                           float* __restrict__ small, int tid) {
  constexpr int Q = DP / 4;  // float4s a row
  static_assert((ROWS * Q) % NT == 0, "whole float4s per thread");
#pragma unroll
  for (int it = 0; it < ROWS * Q / NT; ++it) {
    const int i = tid + it * NT;
    const int off = (i / Q) * LD + (i % Q) * 4;
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in f32 accuracy from split operands, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// two f32 as one bf16x2 word (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 b16 matrices, transposed: lane l addresses row l % 8 of matrix
// l / 8; register i gets matrix i's elements [2t, 2t + 1][g]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// ---------------------------------------------------------------------------
// warp-level products over shared tiles
// ---------------------------------------------------------------------------

// acc[n] (16 x 8 tiles, n < NTILES) += X . Y^T over K columns: X is the warp's
// 16 rows of a shared tile (row stride LDX), Y the NTILES * 8 rows of another
// (row stride LDY); both row-major in k. S = Q . K^T, dP = dO . V^T. In f32, X
// is split here and Y comes split by split_tile (big in Y, small in Ys).
template <typename T, int K, int NTILES, int LDX, int LDY>
__device__ __forceinline__ void mma_abt(float (&acc)[NTILES][4],
                                        const T* __restrict__ X,
                                        const T* __restrict__ Y,
                                        const T* __restrict__ Ys, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 8) {
      const float* xp = X + g * LDX + kk + t;
      uint32_t ab[4], as[4];
      split_tf32(xp[0], ab[0], as[0]);
      split_tf32(xp[8 * LDX], ab[1], as[1]);
      split_tf32(xp[4], ab[2], as[2]);
      split_tf32(xp[8 * LDX + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
        const int o = (n * 8 + g) * LDY + kk + t;
        const uint32_t bb[2] = {__float_as_uint(Y[o]), __float_as_uint(Y[o + 4])};
        const uint32_t bs[2] = {__float_as_uint(Ys[o]),
                                __float_as_uint(Ys[o + 4])};
        mma_3xtf32(acc[n], ab, as, bb, bs);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      const T* xp = X + g * LDX + kk + 2 * t;
      const uint32_t a[4] = {lds32(xp), lds32(xp + 8 * LDX), lds32(xp + 8),
                             lds32(xp + 8 * LDX + 8)};
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
        const T* yp = Y + (n * 8 + g) * LDY + kk + 2 * t;
        const uint32_t b[2] = {lds32(yp), lds32(yp + 8)};
        mma_bf16(acc[n], a, b);
      }
    }
  }
}

// acc[n] (16 x 8 tiles, n < NTILES) += C . Y: C is a warp's 16 x (KT * 8)
// accumulator tile in registers (P or dS, f32; rounded to bf16 here when T is
// bf16), Y the KT * 8 rows of a shared tile (row stride LDY), row-major in n;
// in f32, C is split here and Y comes split (Ys). dQ += dS . K,
// dV += P^T . dO, dK += dS^T . Q. With kFresh, the call's products are summed
// from zero and then added to acc: the tensor cores round each accumulation
// toward zero, so a sum over T keys kept in one MMA accumulator drifts by up to
// (3 T / 8) * 2**-23 of its size, and a fresh sum per call bounds that by the
// call's own KT * 8 terms.
template <typename T, int KT, int NTILES, int LDY, bool kFresh>
__device__ __forceinline__ void mma_ckn(float (&acc)[NTILES][4],
                                        const float (&c)[KT][4],
                                        const T* __restrict__ Y,
                                        const T* __restrict__ Ys, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[NTILES][4] = {};
  float(&d)[NTILES][4] = kFresh ? part : acc;  // where the products go
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      // k slot t <- column 2t, slot t + 4 <- column 2t + 1 (rows g, g + 8)
      uint32_t ab[4], as[4];
      split_tf32(c[j][0], ab[0], as[0]);
      split_tf32(c[j][2], ab[1], as[1]);
      split_tf32(c[j][1], ab[2], as[2]);
      split_tf32(c[j][3], ab[3], as[3]);
      const int o = (j * 8 + 2 * t) * LDY + g;
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
        const uint32_t bb[2] = {__float_as_uint(Y[o + n * 8]),
                                __float_as_uint(Y[o + LDY + n * 8])};
        const uint32_t bs[2] = {__float_as_uint(Ys[o + n * 8]),
                                __float_as_uint(Ys[o + LDY + n * 8])};
        mma_3xtf32(d[n], ab, as, bb, bs);
      }
    }
  } else {
    static_assert(KT % 2 == 0 && NTILES % 2 == 0, "bf16 takes k16 / n16 steps");
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
    for (int j = 0; j < KT; j += 2) {
      const uint32_t a[4] = {pack_bf16(c[j][0], c[j][1]),
                             pack_bf16(c[j][2], c[j][3]),
                             pack_bf16(c[j + 1][0], c[j + 1][1]),
                             pack_bf16(c[j + 1][2], c[j + 1][3])};
      // matrices: rows j*8 + (mi & 1) * 8 + mr, columns n*8 + (mi >> 1) * 8
      const T* yp = Y + (j * 8 + (mi & 1) * 8 + mr) * LDY + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NTILES; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, yp + n * 8);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(d[n], a, b0);
        mma_bf16(d[n + 1], a, b1);
      }
    }
  }
  if constexpr (kFresh) {
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// stores and launches
// ---------------------------------------------------------------------------

// one or two f32 values stored as T (bf16: rounded to nearest even)
__device__ __forceinline__ void store1(float* o, float x) { *o = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
}

// a warp's 16 x (NTILES * 8) accumulator rows r (g) and r + 8 (g + 8) into
// out rows < n (row stride D, columns < D), rounded once to T; a quad writes
// 32 contiguous bytes of a row
template <typename T, int NTILES>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[NTILES][4], int r,
                                          int n, int D, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= n) continue;
    T* o = out + static_cast<long long>(row) * D;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      const int c = j * 8 + 2 * t;
      const float x = acc[j][2 * half], y = acc[j][2 * half + 1];
      if (c + 1 < D && D % 2 == 0) {
        store2(o + c, x, y);
      } else {
        if (c < D) store1(o + c, x);
        if (c + 1 < D) store1(o + c + 1, y);
      }
    }
  }
}

// Dynamic shared memory above 48 KB, allowed once per kernel and device (a
// launch asking for more than allowed is refused and never runs).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit =
      device >= 0 && device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace mma
}  // namespace dl4j
