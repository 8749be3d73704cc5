// Tensor-core building blocks shared by the forward (flash_fwd.cu,
// flash_fwd_tc) and the backward (flash_bwd.cu, dq_dbias_tc and dkdv_tc):
// cp.async tile loaders into wgmma's no-swizzle core layout, the fp32 ->
// TF32 hi/lo splits, and the one routine that computes a tile of logits.
//
// The backward recomputes p = exp(x - m) / l with the m and l of the
// forward.  On a fully masked row the logits sit near -1e9, where one ulp
// is 64: a logit that differs from the forward's by one ulp gives a p of
// e^64.  So every kernel computes its logits with `logits` below, on the
// same tile shape (64 query rows as M, 64 keys as N), the same operands in
// the same order (Q K^T, never K Q^T, which would reorder the TF32
// passes), and the same rounding: __fmul_rn(s, scale), then
// __fadd_rn(bias), then -inf past the key range.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace flash_tc {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// generic-proxy shared-memory writes become visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows x C 16-byte chunks of a row-major tile (row stride `ld` elements)
// into the K-major core layout at dst (chunk idx at idx * 16 bytes, see
// wgmma.cuh); rows from `valid` on are zero-filled
template <typename E, int C>
__device__ __forceinline__ void load_core(unsigned char* dst, const E* src, int64_t ld, int rows,
                                          int valid, bool async) {
  constexpr int CH = 16 / static_cast<int>(sizeof(E));
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int row = (idx / (8 * C)) * 8 + (idx & 7);
    const int c = (idx >> 3) % C;
    const E* s = src + row * ld + c * CH;
    const bool ok = row < valid;
    if (async) {
      cp_async16(wg::smem_addr(dst + idx * 16), ok ? s : src, ok ? 16 : 0);
    } else {
      E* d = reinterpret_cast<E*>(dst + idx * 16);
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = ok ? s[e] : from_f<E>(0.f);
    }
  }
}

// fp32 tile in place -> tf32 hi; tf32 lo into `lo` (same layout)
__device__ __forceinline__ void split_inplace(unsigned char* hi, unsigned char* lo, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) {
    float4 x = *reinterpret_cast<float4*>(hi + i);
    float4 h, l;
    h.x = __uint_as_float(tf32(x.x)); l.x = __uint_as_float(tf32(x.x - h.x));
    h.y = __uint_as_float(tf32(x.y)); l.y = __uint_as_float(tf32(x.y - h.y));
    h.z = __uint_as_float(tf32(x.z)); l.z = __uint_as_float(tf32(x.z - h.z));
    h.w = __uint_as_float(tf32(x.w)); l.w = __uint_as_float(tf32(x.w - h.w));
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) = l;
  }
}

// position of row j of a group of 8 along K in a transposed fp32 operand:
// the tf32 register A fragment holds columns (q, q + 4) where an
// accumulator holds columns (2q, 2q + 1)
__device__ __forceinline__ int tf32_pos(int j) { return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1); }

// fp32 tile [BK rows][D] (K-major core layout) -> its transpose [D][BK]
// hi and lo, K-major core layout, row j of each group of 8 at position
// tf32_pos(j).  Each thread writes one 16-byte chunk of the transpose
// (row d, 4 positions), so a warp's stores are contiguous
template <int D, int BK>
__device__ __forceinline__ void split_transpose_v(const unsigned char* raw, unsigned char* vhi,
                                                  unsigned char* vlo) {
  constexpr int C = D / 4;   // chunks per raw row
  constexpr int CK = BK / 4; // chunks per transposed row
  for (int idx = threadIdx.x; idx < D * CK; idx += blockDim.x) {
    const int d = ((idx >> 3) / CK) * 8 + (idx & 7);
    const int kc = (idx >> 3) % CK;
    // positions 4 kc .. 4 kc + 3 hold rows 8 (kc / 2) + 2 i + kc % 2
    const unsigned char* src = raw + (((kc >> 1) * C + (d >> 2)) * 8 + (kc & 1)) * 16 + (d & 3) * 4;
    float4 h, l;
    float* hp = &h.x;
    float* lp = &l.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = *reinterpret_cast<const float*>(src + i * 32);
      hp[i] = __uint_as_float(tf32(x));
      lp[i] = __uint_as_float(tf32(x - hp[i]));
    }
    *reinterpret_cast<float4*>(vhi + idx * 16) = h;
    *reinterpret_cast<float4*>(vlo + idx * 16) = l;
  }
}

// s (64 x BK fp32 fragments) = A B^T for one warpgroup: A [64 rows][D] at
// a (fp32: hi at a, lo at alo), B [BK rows][D] at b (blo), both K-major
// core layout with D / (16-byte chunk) chunks per row.  fp32 runs three
// TF32 passes per k8 step, hi*hi, hi*lo, lo*hi, in that order; bf16 one
// k16 product.  Issued and waited for here.
template <bool F32, int D, int BK>
__device__ __forceinline__ void tile_product(float (&s)[BK / 2], const unsigned char* a,
                                             const unsigned char* alo, const unsigned char* b,
                                             const unsigned char* blo) {
  constexpr uint32_t SBO = (D / (F32 ? 4 : 8)) * 128;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wg::fence();
  if constexpr (F32) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t ah = wg::desc(wg::smem_addr(a + ks * 256), 128, SBO);
      const uint64_t al = wg::desc(wg::smem_addr(alo + ks * 256), 128, SBO);
      const uint64_t bh = wg::desc(wg::smem_addr(b + ks * 256), 128, SBO);
      const uint64_t bl = wg::desc(wg::smem_addr(blo + ks * 256), 128, SBO);
      wg::Mma<BK>::ss_tf32(s, ah, bh);
      wg::Mma<BK>::ss_tf32(s, ah, bl);
      wg::Mma<BK>::ss_tf32(s, al, bh);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wg::Mma<BK>::ss_bf16(s, wg::desc(wg::smem_addr(a + ks * 256), 128, SBO),
                           wg::desc(wg::smem_addr(b + ks * 256), 128, SBO));
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(s);
}

// The logits of a tile: s = (Q K^T) * scale + bias, -inf from key column
// `valid` on.  Q: the warpgroup's 64 query rows, K: BK keys, as in
// tile_product.  `after()` runs between the product and the rounding (the
// forward refills the K buffer there).  `bias(c, hh)` gives the bias pair
// of the thread's row 16 w + g + 8 hh of the tile, key columns 8 c + 2 q
// and 8 c + 2 q + 1; with `with_bias` false it is not called.
template <bool F32, int D, int BK, typename After, typename Bias>
__device__ __forceinline__ void logits(float (&s)[BK / 2], const unsigned char* q,
                                       const unsigned char* qlo, const unsigned char* k,
                                       const unsigned char* klo, float scale, int valid,
                                       bool with_bias, After after, Bias bias) {
  tile_product<F32, D, BK>(s, q, qlo, k, klo);
  after();
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = 8 * c + 2 * qd;
      float2 bb = make_float2(0.f, 0.f);
      if (with_bias) bb = bias(c, hh);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = __fmul_rn(s[4 * c + 2 * hh + j], scale);
        if (with_bias) x = __fadd_rn(x, j ? bb.y : bb.x);
        if (col + j >= valid) x = -INFINITY;
        s[4 * c + 2 * hh + j] = x;
      }
    }
  }
}

}  // namespace flash_tc
