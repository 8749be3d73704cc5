// Flash-attention forward with an additive bias, for Hopper (sm_90a).
//
//   o[b, h, i, :] = softmax_j(q[b,h,i,:] . k[b,h,j,:] / sqrt(D) + bias[(b*H + h) % lead, i, j]) @ v[b,h,j,:]
//
// One source serves the five forward Pallas kernels of the JAX package
// (physdock_tpu/ops/flash_attention.py::flash_sdpa,
//  flash_attention_grouped.py::flash_sdpa_grouped,
//  flash_attention_folded.py::flash_sdpa_folded,
//  flash_attention_folded_v3.py::flash_sdpa_folded_v3,
//  flash_attention_bwd.py::flash_fwd_lse).  On the TPU they
// differ only in how heads are folded into lanes and how samples are
// grouped around VMEM; here the split [B, H, S, D] and folded [B, S, H*D]
// layouts are both just strides, and a bias shared over B is the
// `(b*H + h) % lead` row-block index (lead = H gives a sample stride of 0).
// The bias is added as given: a -1e9 / -2e9 mask entry is an ordinary
// logit, so a fully masked row softmaxes over its bias exactly as the
// einsum reference does.  Keys past S_k get -inf; query rows past S_q are
// computed on zeros and not stored.  Running max and sum are fp32.
//
// Two kernels:
//
// flash_fwd_tc (every call of the first four, and flash_fwd_lse wherever
// the backward runs on the tensor cores: D = 32 and 64) runs both
// products on the tensor cores with wgmma (wgmma.cuh).  A block holds two
// warpgroups of 128 threads, each on 64 query rows of one (b, h), which
// share every K / V tile and its fp32 split (one warpgroup where S_q <= 64,
// or for fp32 at D = 128, where two would not fit 227 KB):
//   - S = Q K^T: Q [rows][D] and K [keys][D] are both K-major as they lie;
//     bf16 is m64n64k16, fp32 is m64nBKk8 in TF32 run three times,
//     hi*hi + hi*lo + lo*hi with hi = cvt.rna.tf32(x), lo = tf32(x - hi)
//     (one TF32 pass is 3-5e-4 off fp32 at the atom-DiT shape, three are
//     ~1e-6, and the plain version is held to 1e-4).  The product and its
//     rounding (x = s * scale, then + bias, -inf past the keys) are
//     flash_tc.cuh's `logits`, the routine the backward recomputes them
//     with, so its x - m is this kernel's to the bit.
//   - The softmax runs on the accumulator fragments in registers: quad
//     shuffles for the row max, each thread keeps its partial row sums.
//   - O += P V: bf16 P goes from the S accumulator straight into the
//     register A operand, V is read as an MN-major B; fp32 P is split
//     into hi/lo registers, and V is written transposed ([D][keys], hi
//     and lo) as the tile lands, its keys permuted within each group of 8
//     to match the TF32 register-fragment order.  Three passes again.
//   - K, V and bias tiles arrive by cp.async while the previous tile is
//     multiplied: in bf16 through a two-stage ring; in fp32 through one
//     buffer each, refilled as soon as it has been read (raw V once split,
//     raw K once S is done, the bias once the softmax has read it), which
//     keeps fp32 at 109 KB of shared memory at D = 32, two blocks per SM.
//     Rows that are not 16-byte aligned (a bias row of a ragged S_k, an
//     odd view) are copied by plain loads; keys past the range are
//     zero-filled.
//   - Blocks are numbered batch fastest, so the B blocks of one (h, query
//     tile) run together and read its bias stripe from L2, not HBM (at the
//     atom-DiT shape the head-fastest order measured the same).
//   - When B*H*ceil(S_q/64) is too few warpgroups to fill the card, the
//     keys are cut into chunks (grid z): each chunk writes fp32 partials
//     (o unnormalized, m, l kept apart, never fused as m + log l, which
//     loses log l below ulp(1e9) on masked rows), and flash_fwd_combine
//     merges them.
//   - With stats (flash_fwd_lse) it stores each query row's fp32 max m
//     and normalizer l separately ([B, H, S_q], contiguous); split, the
//     combine stores m = max_z m_z and l = sum_z l_z e^(m_z - m).
// Bound on this card: at the atom-DiT shape (B=20, H=4, S=2048, D=32) the
// products are 43 GFLOP (0.043 ms at bf16 peak, 0.087 ms at TF32 peak for
// one pass), the exponentials 0.34 G (0.086 ms at ~3.9 T/s) and the
// traffic 0.15 GB (0.045 ms): the TF32 products (fp32) and exp (bf16) bound it.
//
// flash_fwd_kernel (flash_fwd_lse at D = 128, and on request) is the
// first, SIMT design, the forward of the SIMT training pair: one block of
// 128 threads per (b, h, 64-row query tile), inputs widened to fp32 in
// shared memory, every product an fp32 FMA on the CUDA cores.  The SIMT
// backward recomputes p = exp(s*scale + bias - m) / l in this kernel's
// exact FMA order, which is how s - m cancels a -1e9 bias exactly: where
// |s*scale| crosses a rounding boundary of -1e9 (ulp 64), a forward that
// summed the logits in another order could give an m one ulp off, e^64 in
// exp.  So the pair is chosen as a whole (_flash_lib.py `tc_pair`), never
// one kernel of it.  It stores m and l as flash_fwd_tc does.
//
// Plain C interface, bound with ctypes (physdock_tpu_torch/ops/_flash_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block: 16 (tx) x 8 (ty)
constexpr int RPT = BQ / 8;   // query rows per thread
constexpr int CPT = BK / 16;  // key columns per thread

using flash_tc::from_f;
using flash_tc::to_f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  void* o;
  float* m;  // [B, H, S_q] row max, or null
  float* l;  // [B, H, S_q] row normalizer, or null
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t b_sl, b_ss;  // bias: row-block stride and row stride (keys contiguous)
  int B, H, S_q, S_k, lead;  // lead == 0: no bias
  float scale;
  // key chunks of flash_fwd_tc: chunk z covers keys [z * key_chunk, ...);
  // with o_part, fp32 partials [n_split][B*H][S_q] (x D for o_part)
  int key_chunk;
  float* o_part;
  float* m_part;
  float* l_part;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, typename TB, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DP = D + 1;     // padded row: conflict-free column reads
  constexpr int DPT = D / 16;   // output dims per thread
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // batch fastest: consecutive blocks share (h, query tile) and so the bias tile
  const int h = blockIdx.x / p.B;
  const int b = blockIdx.x % p.B;
  const int q0 = blockIdx.y * BQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const TB* bias = nullptr;
  if (p.lead > 0) {
    const int64_t blk = (static_cast<int64_t>(b) * p.H + h) % p.lead;
    bias = static_cast<const TB*>(p.bias) + blk * p.b_sl;
  }

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    sQ[r * DP + d] = qi < p.S_q ? to_f(q[qi * p.q_ss + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  const int nk = (p.S_k + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < p.S_k) {
        kv = to_f(k[kj * p.k_ss + d]);
        vv = to_f(v[kj * p.v_ss + d]);
      }
      sK[r * DP + d] = kv;
      sV[r * D + d] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int qi = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = -INFINITY;
        if (kj < p.S_k) {
          x = s[i][j] * p.scale;
          if (bias != nullptr && qi < p.S_q) x += to_f(bias[qi * p.b_ss + kj]);
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        sP[r * PP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = sV[c * D + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pv = sP[(ty * RPT + i) * PP + c];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(pv, vv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi < p.S_q) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        o[qi * p.o_ss + tx + 16 * dd] = from_f<T>(acc[i][dd] * inv);
      // every thread of the 16-lane row group holds the same reduced m, l
      if (p.m != nullptr && tx == 0) {
        const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.S_q + qi;
        p.m[row] = m[i];
        p.l[row] = l[i];
      }
    }
  }
}

// ------------------------------------------------------------ flash_fwd_tc

namespace tc {

using namespace ::flash_tc;

constexpr int NST = 2;  // stages of the K / V / bias ring

__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bias rows q0.. x keys k0.. (rows x BK) into a padded row-major tile
template <typename TB, int BK, int BROW>
__device__ __forceinline__ void load_bias(TB* dst, const TB* bias, int64_t ld, int rows, int q0,
                                          int k0, int S_q, int k_end) {
  constexpr int CH = 16 / static_cast<int>(sizeof(TB));
  constexpr int CB = BK / CH;
  for (int idx = threadIdx.x; idx < rows * CB; idx += blockDim.x) {
    const int r = idx / CB, c = idx % CB;
    const int kc = k0 + c * CH;
    const int n = (q0 + r < S_q) ? min(CH, k_end - kc) : 0;
    const TB* s = bias + (q0 + r) * ld + kc;
    TB* d = dst + r * BROW + c * CH;
    if (n == CH && aligned16(s)) {
      cp_async16(wg::smem_addr(d), s, 16);
    } else if (n <= 0) {
      cp_async16(wg::smem_addr(d), bias, 0);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = e < n ? s[e] : from_f<TB>(0.f);
    }
  }
}

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BK = (F32 && D == 128) ? 32 : 64;  // keys per tile (fits 227 KB)
  static constexpr int CH = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  static constexpr int C = D / CH;                             // chunks per q/k/v row
  // consumer warpgroups per block, each on 64 query rows, sharing every
  // K / V tile (and its fp32 split): two, but one where two would not fit
  // 227 KB (fp32 at D = 128) or where S_q fills one
  static constexpr int MAX_WGS = (F32 && D == 128) ? 1 : 2;
  static int wgs(const Params& p) { return MAX_WGS == 2 && p.S_q > BQ ? 2 : 1; }
  static constexpr int Q_BYTES = BQ * D * static_cast<int>(sizeof(T));  // per warpgroup
  static constexpr int KV_BYTES = BK * D * static_cast<int>(sizeof(T));
  static constexpr int BROW = BK + 8;  // padded bias row: conflict-free fragment reads
  // ring stages: bf16 takes two when a block walks more than one key
  // tile; fp32 takes one, each buffer refilled as soon as it is read
  static constexpr int MAX_STAGES = F32 ? 1 : NST;
  static __host__ __device__ int stages(const Params& p) {
    return !F32 && (p.key_chunk < p.S_k ? p.key_chunk : p.S_k) > BK ? NST : 1;
  }
  template <typename TB>
  static __host__ __device__ int smem_bytes(int nst, bool bias, int wgs) {
    return wgs * Q_BYTES * (F32 ? 2 : 1) + KV_BYTES * (2 * nst + (F32 ? 3 : 0)) +
           (bias ? nst * wgs * BQ * BROW * static_cast<int>(sizeof(TB)) : 0);
  }
};

template <typename T, typename TB, int D, int WGS>
__global__ void __launch_bounds__(WGS * NT) flash_fwd_tc(const Params p) {
  using K = Cfg<T, D>;
  constexpr bool F32 = K::F32;
  constexpr int BK = K::BK, C = K::C, BROW = K::BROW;
  constexpr int NC = BK / 8;                  // 8-key column blocks of S
  constexpr uint32_t SBO_QK = C * 128;        // K-major Q and K
  constexpr uint32_t SBO_VT = (BK / 4) * 128; // fp32 V^T, K = keys
  const int nst = K::stages(p);
  constexpr int bq = WGS * BQ;  // query rows of the block
  constexpr int q_bytes = WGS * K::Q_BYTES;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* sQ = tc_smem;
  unsigned char* sQlo = sQ + q_bytes;
  unsigned char* sK = sQlo + (F32 ? q_bytes : 0);
  unsigned char* sKlo = sK + nst * K::KV_BYTES;
  unsigned char* sV = sKlo + (F32 ? K::KV_BYTES : 0);
  unsigned char* sVhi = sV + nst * K::KV_BYTES;
  unsigned char* sVlo = sVhi + (F32 ? K::KV_BYTES : 0);
  TB* sB = reinterpret_cast<TB*>(sVlo + (F32 ? K::KV_BYTES : 0));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wq = (warp >> 2) * 8 * SBO_QK;  // this warpgroup's 64 rows of Q
  // batch fastest: consecutive blocks share (h, query tile) and so the bias tile
  const int h = blockIdx.x / p.B;
  const int b = blockIdx.x % p.B;
  const int q0 = blockIdx.y * bq;
  const int kb = blockIdx.z * p.key_chunk;
  const int ke = min(p.S_k, kb + p.key_chunk);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const TB* bias = nullptr;
  if (p.lead > 0) {
    const int64_t blk = (static_cast<int64_t>(b) * p.H + h) % p.lead;
    bias = static_cast<const TB*>(p.bias) + blk * p.b_sl;
  }
  const bool q_async = aligned16(q) && (p.q_ss * sizeof(T)) % 16 == 0;
  const bool k_async = aligned16(k) && (p.k_ss * sizeof(T)) % 16 == 0;
  const bool v_async = aligned16(v) && (p.v_ss * sizeof(T)) % 16 == 0;

  auto load_k = [&](int k0, int st) {
    load_core<T, C>(sK + st * K::KV_BYTES, k + k0 * p.k_ss, p.k_ss, BK, ke - k0, k_async);
  };
  auto load_v = [&](int k0, int st) {
    load_core<T, C>(sV + st * K::KV_BYTES, v + k0 * p.v_ss, p.v_ss, BK, ke - k0, v_async);
  };
  auto load_b = [&](int k0, int st) {
    if (bias != nullptr)
      load_bias<TB, BK, BROW>(sB + st * bq * BROW, bias, p.b_ss, bq, q0, k0, p.S_q, ke);
  };

  load_core<T, C>(sQ, q + q0 * p.q_ss, p.q_ss, bq, p.S_q - q0, q_async);
  load_k(kb, 0);
  load_v(kb, 0);
  load_b(kb, 0);
  cp_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int nt = (ke - kb + BK - 1) / BK;
  for (int t = 0; t < nt; ++t) {
    const int k0 = kb + t * BK;
    const int st = t % nst;
    const bool next = t + 1 < nt;
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed; every reader of stage (t + 1) % nst is done
    unsigned char* kt = sK + st * K::KV_BYTES;
    if constexpr (F32) {
      // one buffer each: raw V is free once split, raw K once S is done,
      // the bias once the softmax has read it; each refill overlaps the rest
      if (t == 0) split_inplace(sQ, sQlo, q_bytes);
      split_inplace(kt, sKlo, K::KV_BYTES);
      split_transpose_v<D, BK>(sV, sVhi, sVlo);
      fence_async_smem();
      __syncthreads();
      if (next) load_v(k0 + BK, 0);
    } else if (next) {
      load_k(k0 + BK, (t + 1) % nst);
      load_v(k0 + BK, (t + 1) % nst);
      load_b(k0 + BK, (t + 1) % nst);
    }
    cp_commit();

    // S = Q K^T, rounded: the routine the backward recomputes it with
    const TB* bt = sB + st * bq * BROW;
    float s[BK / 2];
    logits<F32, D, BK>(
        s, sQ + wq, sQlo + wq, kt, sKlo, p.scale, ke - k0, bias != nullptr,
        [&] {
          if constexpr (F32) {
            __syncthreads();  // every warp's part of S is done: K is free
            if (next) load_k(k0 + BK, 0);
            cp_commit();
          }
        },
        [&](int c, int hh) { return load_pair(bt + (warp * 16 + g + 8 * hh) * BROW + 8 * c + 2 * qd); });

    // online softmax on the fragments: rows r0 = 16 warp + g and r0 + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      // every tile holds at least one key of the range, so m_new is finite
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = exp2f((m[hh] - m_new) * LOG2E);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = i >> 1;
        const float e = exp2f((s[4 * c + i] - m[hh]) * LOG2E);
        s[4 * c + i] = e;
        l[hh] += e;
      }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    if constexpr (F32) {
      __syncthreads();  // every thread has read this bias tile
      if (next) load_b(k0 + BK, 0);
      cp_commit();
    }

    // O += P V
    if constexpr (F32) {
      uint32_t ph[NC][4], pl[NC][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x[4] = {s[4 * c], s[4 * c + 2], s[4 * c + 1], s[4 * c + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ph[c][r] = tf32(x[r]);
          pl[c][r] = tf32(x[r] - __uint_as_float(ph[c][r]));
        }
      }
      wg::fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t vh = wg::desc(wg::smem_addr(sVhi + c * 256), 128, SBO_VT);
        const uint64_t vl = wg::desc(wg::smem_addr(sVlo + c * 256), 128, SBO_VT);
        wg::Mma<D>::rs_tf32(o, ph[c], vh);
        wg::Mma<D>::rs_tf32(o, ph[c], vl);
        wg::Mma<D>::rs_tf32(o, pl[c], vh);
      }
      wg::commit();
      wg::wait_all();
      fence_regs(ph);
      fence_regs(pl);
    } else {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wg::fence();
      const unsigned char* vt = sV + st * K::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::Mma<D>::rs_bf16_mn(o, pa[kk], wg::desc(wg::smem_addr(vt + kk * 2 * C * 128), C * 128, 128));
      wg::commit();
      wg::wait_all();
      fence_regs(pa);
    }
    wg::fence_regs(o);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + g + 8 * hh;
    if (qi >= p.S_q) continue;
    if (p.o_part != nullptr) {
      const int64_t row = (blockIdx.z * static_cast<int64_t>(p.B) * p.H + bh) * p.S_q + qi;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store_pair(p.o_part + row * D + 8 * c + 2 * qd, o[4 * c + 2 * hh], o[4 * c + 2 * hh + 1]);
      if (qd == 0) {
        p.m_part[row] = m[hh];
        p.l_part[row] = l[hh];
      }
    } else {
      const float inv = 1.f / l[hh];
      T* orow = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store_pair(orow + 8 * c + 2 * qd, o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
      // with stats (the forward of training): the row's max and normalizer
      if (p.m != nullptr && qd == 0) {
        p.m[bh * p.S_q + qi] = m[hh];
        p.l[bh * p.S_q + qi] = l[hh];
      }
    }
  }
}

// o[b, h, i, :] from the n_split chunks' partials: the chunk maxima are
// brought to their common max, and o = sum(o_z w_z) / sum(l_z w_z); with
// stats, m = max_z m_z and l = sum(l_z w_z) as well
template <typename T>
__global__ void flash_fwd_combine(const Params p, int n_split, int D) {
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.S_q;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < rows * D;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = idx / D;
    const int d = static_cast<int>(idx % D);
    float mz = -INFINITY;
    for (int z = 0; z < n_split; ++z) mz = fmaxf(mz, p.m_part[z * rows + row]);
    float l = 0.f, acc = 0.f;
    for (int z = 0; z < n_split; ++z) {
      const float w = expf(p.m_part[z * rows + row] - mz);
      l += p.l_part[z * rows + row] * w;
      acc += p.o_part[(z * rows + row) * D + d] * w;
    }
    const int qi = static_cast<int>(row % p.S_q);
    const int64_t bh = row / p.S_q;
    const int b = static_cast<int>(bh / p.H), h = static_cast<int>(bh % p.H);
    static_cast<T*>(p.o)[b * p.o_sb + h * p.o_sh + qi * p.o_ss + d] = from_f<T>(acc * (1.f / l));
    if (p.m != nullptr && d == 0) {
      p.m[row] = mz;
      p.l[row] = l;
    }
  }
}

}  // namespace tc

template <typename T, typename TB, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, TB, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(p.B * p.H, (p.S_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, TB, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TB, int D, int WGS>
cudaError_t launch_tc_wgs(const Params& p, int n_split, cudaStream_t stream) {
  using K = tc::Cfg<T, D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        tc::flash_fwd_tc<T, TB, D, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::template smem_bytes<TB>(K::MAX_STAGES, true, WGS));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int smem = K::template smem_bytes<TB>(K::stages(p), p.lead > 0, WGS);
  dim3 grid(p.B * p.H, (p.S_q + WGS * BQ - 1) / (WGS * BQ), n_split);
  tc::flash_fwd_tc<T, TB, D, WGS><<<grid, WGS * NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TB, int D>
cudaError_t launch_tc(const Params& p, int n_split, cudaStream_t stream) {
  using K = tc::Cfg<T, D>;
  cudaError_t e;
  if constexpr (K::MAX_WGS == 2) {
    e = K::wgs(p) == 2 ? launch_tc_wgs<T, TB, D, 2>(p, n_split, stream)
                       : launch_tc_wgs<T, TB, D, 1>(p, n_split, stream);
  } else {
    e = launch_tc_wgs<T, TB, D, 1>(p, n_split, stream);
  }
  if (e != cudaSuccess || p.o_part == nullptr) return e;
  const int64_t total = static_cast<int64_t>(p.B) * p.H * p.S_q * D;
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  tc::flash_fwd_combine<T><<<blocks, 256, 0, stream>>>(p, n_split, D);
  return cudaGetLastError();
}

// `simt` (with stats only): the SIMT kernel; else the tensor-core kernel
// over n_split key chunks
template <typename T, typename TB>
cudaError_t dispatch_d(int d, const Params& p, int n_split, bool simt, cudaStream_t stream) {
  switch (d) {
    case 32: return simt ? launch_simt<T, TB, 32>(p, stream) : launch_tc<T, TB, 32>(p, n_split, stream);
    case 64: return simt ? launch_simt<T, TB, 64>(p, stream) : launch_tc<T, TB, 64>(p, n_split, stream);
    case 128: return simt ? launch_simt<T, TB, 128>(p, stream) : launch_tc<T, TB, 128>(p, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int bias_dtype, int d, const Params& p, int n_split, bool simt,
                     cudaStream_t s) {
  if (simt && (p.m == nullptr || n_split != 1)) return cudaErrorInvalidValue;
  if (dtype == 0 && bias_dtype == 0) return dispatch_d<float, float>(d, p, n_split, simt, s);
  if (dtype == 0 && bias_dtype == 1) return dispatch_d<float, __nv_bfloat16>(d, p, n_split, simt, s);
  if (dtype == 1 && bias_dtype == 0) return dispatch_d<__nv_bfloat16, float>(d, p, n_split, simt, s);
  if (dtype == 1 && bias_dtype == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, p, n_split, simt, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements; the
// last (head-dim / key) axis of every tensor is contiguous.  `m` and `l`
// are null (forward only) or fp32 [B, H, S_q] contiguous (forward with
// stats).  `simt` = 1 takes the SIMT kernel (stats only), else the
// tensor-core kernel.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(
    int dtype, int bias_dtype, int d,
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float* m, float* l,
    const void* bias, int64_t b_sl, int64_t b_ss, int lead,
    int B, int H, int S_q, int S_k, float scale, void* stream, int simt) {
  if (B <= 0 || H <= 0 || S_q <= 0) return 0;
  if (S_k <= 0 || (m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, bias, o, m, l,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           b_sl, b_ss, B, H, S_q, S_k, lead, scale, S_k, nullptr, nullptr, nullptr};
  return static_cast<int>(
      dispatch(dtype, bias_dtype, d, p, 1, simt != 0, static_cast<cudaStream_t>(stream)));
}

// The tensor-core forward with its keys cut into n_split chunks of
// key_chunk keys (a multiple of 64; every chunk non-empty): o_part fp32
// [n_split, B*H, S_q, D], m_part and l_part fp32 [n_split, B*H, S_q], then
// the combine into o (and, with stats, into m and l).  Other arguments as
// flash_fwd's.
extern "C" int flash_fwd_split(
    int dtype, int bias_dtype, int d,
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    const void* bias, int64_t b_sl, int64_t b_ss, int lead,
    int B, int H, int S_q, int S_k, float scale,
    int key_chunk, int n_split, float* o_part, float* m_part, float* l_part, void* stream,
    float* m, float* l) {
  if (B <= 0 || H <= 0 || S_q <= 0) return 0;
  if (S_k <= 0 || key_chunk <= 0 || key_chunk % 64 != 0 || n_split < 1 || (m == nullptr) != (l == nullptr) ||
      static_cast<int64_t>(key_chunk) * (n_split - 1) >= S_k)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, bias, o, m, l,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           b_sl, b_ss, B, H, S_q, S_k, lead, scale, key_chunk, o_part, m_part, l_part};
  return static_cast<int>(
      dispatch(dtype, bias_dtype, d, p, n_split, false, static_cast<cudaStream_t>(stream)));
}
