// Flash-attention backward with a bias shared over the batch, for Hopper
// (sm_90a).  Replaces physdock_tpu/ops/flash_attention_bwd.py::flash_bwd
// (Pallas kernels _bwd_q_kernel and _bwd_kv_kernel).
//
//   P_ij  = exp(q_i . k_j / sqrt(D) + bias[h, i, j] - m_i) / l_i
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij * (dO_i . v_j - delta_i),   delta_i = sum_d dO_id O_id
//   dQ_i  = sum_j dS_ij k_j / sqrt(D)
//   dK_j  = sum_i dS_ij q_i / sqrt(D)
//   dB_ij = sum_b dS_ij                      (fp32)
//
// m and l are the row max and normalizer stored SEPARATELY by the forward
// (flash_fwd.cu with stats).  Subtracting m cancels a -1e9 mask bias
// exactly; the fused exp(logits - lse) lost log(l) below ulp(1e9) and blew
// fully masked rows' gradients up 10-60x on the TPU.  delta is computed by
// the caller (the JAX package does it outside Pallas too).
//
// Two kernels, as on the TPU, plus a reduction:
//   * dkdv: one block per (b, h, key tile); the key tile's k and v stay in
//     shared memory while the block loops over every query tile.
//   * dq_dbias: on the TPU, dbias was summed over B by revisiting one VMEM
//     block on a sequential grid with the batch fastest.  Blocks here run
//     concurrently, so that pattern would race.  Instead each block owns
//     one (h, query tile, batch group) and walks the batch of its group in
//     order, adding each b's dS into its own rows of an fp32 partial sum:
//     no atomics, and every element has exactly one writer.  With G > 1
//     groups (enough blocks to fill the card), a third kernel adds the G
//     partials in group order.  The sum is deterministic run to run.
//
// Two designs of the pair, chosen by the caller per (dtype, D) together
// with the forward that made m and l (physdock_tpu_torch/ops/_flash_lib.py
// `tc_pair`), never as a fallback:
//
// Tensor cores (dq_dbias_tc, dkdv_tc; D = 32 and 64, with flash_fwd_tc's
// stats): one warpgroup of 128 threads per block, tiles of 64 query rows
// and 64 keys, products on wgmma (bf16, or fp32 as three TF32 passes
// hi*hi + hi*lo + lo*hi), tiles filled by cp.async; no key split, no TMA,
// no warp specialization.
//   - S comes from flash_tc.cuh's `logits`, the forward's own routine on
//     the same tile (64 query rows as M, 64 keys as N), so x - m is the
//     forward's to the bit, and a fully masked row's p stays finite.
//   - dP = dO V^T is the same K-major product as S (tile_product); P =
//     exp(x - m) * (1/l) and dS = P (dP - delta) stay in the accumulator
//     registers.
//   - dq_dbias_tc: dQ += dS K with dS as the register A operand (as P in
//     the forward) and K the B operand: MN-major as it lies in bf16, split
//     and transposed as it lands in fp32 (split_transpose_v, keys permuted
//     within groups of 8 to match the TF32 fragment).  dS goes from the
//     registers into the group's fp32 dbias partial.
//   - dkdv_tc: P and dS are stored to shared memory transposed ([key]
//     [query], K-major A operands; fp32 split into hi and lo at the store,
//     with the queries permuted as split_transpose_v permutes the B rows),
//     and dV += P^T dO, dK += dS^T Q run with dO and Q as B: MN-major in
//     bf16, split and transposed in fp32.
//   - The bias is read from global memory (L2) into the rounding, as the
//     pair of a thread's accumulator columns.
// Bound on this card: at the atom-DiT training shape (B=48, H=4, S=2048,
// D=32) the five products are 10*B*H*S^2*D = 258 GFLOP, 0.26 ms at the
// bf16 peak and 0.52 ms at the TF32 peak (one pass; three are run); the
// exponentials 0.8 G (0.2 ms at ~3.9 T/s); the dbias partial, read and
// written once per sample, B*H*S^2*8 B = 6.4 GB (1.9 ms): that traffic
// bounds the design (a loop order that sums a group's samples before
// writing would remove it).
//
// SIMT (dkdv_kernel, dq_dbias_kernel; D = 128, with the forward's SIMT
// stats path): the first design, fp32 on the CUDA cores, 128 threads
// (16 x 8) per block, tiles of 64 query rows and 64 keys (32 keys at
// D = 128 to stay inside the registers), inputs widened to fp32 on load,
// each logit recomputed in the SIMT forward's FMA order.  Rows past S_q
// and keys past S_k get P = 0.  Its products bound it at 67 TFLOP/s.
//
// Plain C interface, bound with ctypes (physdock_tpu_torch/ops/_flash_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NT = 128;      // threads per block: 16 (tx) x 8 (ty)
constexpr int BQ = 64;       // query rows per tile
constexpr int RQ = BQ / 8;   // query rows per thread in the score tile

using flash_tc::from_f;
using flash_tc::to_f;

template <int D> constexpr int key_tile() { return D == 128 ? 32 : 64; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const void* bias;     // [H, S_q, S_k] contiguous
  const float* m;       // [B, H, S_q] contiguous
  const float* l;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;         // [G, H, S_q, S_k] partial sums (G == 1: the result)
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int B, H, S_q, S_k, G;
  float scale;
};

// Shared-memory tiles, fp32, rows padded by one for conflict-free column reads.
template <int D>
struct Smem {
  static constexpr int BK = key_tile<D>();
  static constexpr int DP = D + 1;
  static constexpr int PP = BK + 1;
  static constexpr int floats = 2 * BQ * DP + 2 * BK * DP + 2 * BQ * PP + 3 * BQ;
  float* q; float* dO; float* k; float* v; float* p; float* ds;
  float* m; float* linv; float* delta;
  __device__ explicit Smem(float* base) {
    q = base;
    dO = q + BQ * DP;
    k = dO + BQ * DP;
    v = k + BK * DP;
    p = v + BK * DP;
    ds = p + BQ * PP;
    m = ds + BQ * PP;
    linv = m + BQ;
    delta = linv + BQ;
  }
};

// q and dO rows [q0, q0+BQ) of (b, h), with their m, 1/l and delta.
template <typename T, int D>
__device__ void load_q_tile(const Params& p, const Smem<D>& s, int b, int h, int q0) {
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dO) + b * p.do_sb + h * p.do_sh;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    float qv = 0.f, dv = 0.f;
    if (qi < p.S_q) {
      qv = to_f(q[qi * p.q_ss + d]);
      dv = to_f(dO[qi * p.do_ss + d]);
    }
    s.q[r * Smem<D>::DP + d] = qv;
    s.dO[r * Smem<D>::DP + d] = dv;
  }
  const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.S_q;
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int qi = q0 + r;
    const bool in = qi < p.S_q;
    s.m[r] = in ? p.m[row0 + qi] : 0.f;
    s.linv[r] = in ? 1.f / p.l[row0 + qi] : 0.f;
    s.delta[r] = in ? p.delta[row0 + qi] : 0.f;
  }
}

// k and v rows [k0, k0+BK) of (b, h).
template <typename T, int D>
__device__ void load_k_tile(const Params& p, const Smem<D>& s, int b, int h, int k0) {
  constexpr int BK = Smem<D>::BK;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int idx = threadIdx.x; idx < BK * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int kj = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (kj < p.S_k) {
      kv = to_f(k[kj * p.k_ss + d]);
      vv = to_f(v[kj * p.v_ss + d]);
    }
    s.k[r * Smem<D>::DP + d] = kv;
    s.v[r * Smem<D>::DP + d] = vv;
  }
}

// P and dS of the current (query tile, key tile) into s.p and s.ds.  Thread
// (tx, ty) computes rows ty*RQ + i and keys tx + 16*j.  With `dbias`, it
// also adds its dS entries into the block's own fp32 dbias rows (`first`:
// store instead of add).
template <typename TB, int D>
__device__ void p_and_ds(const Params& p, const Smem<D>& s, const TB* bias, int q0, int k0,
                         float* dbias, bool first) {
  constexpr int BK = Smem<D>::BK;
  constexpr int CK = BK / 16;
  constexpr int DP = Smem<D>::DP;
  constexpr int PP = Smem<D>::PP;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = s.q[(ty * RQ + i) * DP + d];
      ov[i] = s.dO[(ty * RQ + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = s.k[(tx + 16 * j) * DP + d];
      vv[j] = s.v[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const int qi = q0 + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      float pv = 0.f, dsv = 0.f;
      if (qi < p.S_q && kj < p.S_k) {
        const int64_t bi = static_cast<int64_t>(qi) * p.S_k + kj;
        const float x = sc[i][j] * p.scale + to_f(bias[bi]);
        pv = expf(x - s.m[r]) * s.linv[r];
        dsv = pv * (dp[i][j] - s.delta[r]);
        if (dbias != nullptr) dbias[bi] = first ? dsv : dbias[bi] + dsv;
      }
      s.p[r * PP + c] = pv;
      s.ds[r * PP + c] = dsv;
    }
  }
}

// grid (B*H, key tiles): dk, dv of one key tile, looping over query tiles.
template <typename T, typename TB, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const Params p) {
  constexpr int BK = Smem<D>::BK;
  constexpr int RK = BK / 8;    // key rows per thread
  constexpr int DPT = D / 16;   // head dims per thread
  constexpr int DP = Smem<D>::DP;
  constexpr int PP = Smem<D>::PP;
  extern __shared__ float smem[];
  const Smem<D> s(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * BK;
  const TB* bias = static_cast<const TB*>(p.bias) + static_cast<int64_t>(h) * p.S_q * p.S_k;

  load_k_tile<T, D>(p, s, b, h, k0);
  float dk[RK][DPT], dv[RK][DPT];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dk[r][dd] = dv[r][dd] = 0.f;

  const int nq = (p.S_q + BQ - 1) / BQ;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_q_tile<T, D>(p, s, b, h, q0);
    __syncthreads();
    p_and_ds<TB, D>(p, s, bias, q0, k0, nullptr, false);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float qv[DPT], ov[DPT];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        qv[dd] = s.q[i * DP + tx + 16 * dd];
        ov[dd] = s.dO[i * DP + tx + 16 * dd];
      }
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const float pv = s.p[i * PP + ty * RK + r];
        const float dsv = s.ds[i * PP + ty * RK + r];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          dv[r][dd] = fmaf(pv, ov[dd], dv[r][dd]);
          dk[r][dd] = fmaf(dsv, qv[dd], dk[r][dd]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv_out = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kj = k0 + ty * RK + r;
    if (kj < p.S_k) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        dk_out[kj * p.dk_ss + tx + 16 * dd] = from_f<T>(dk[r][dd] * p.scale);
        dv_out[kj * p.dv_ss + tx + 16 * dd] = from_f<T>(dv[r][dd]);
      }
    }
  }
}

// grid (H * query tiles, G): dq of each b in the group, in order, and the
// group's dbias partial over its own query rows (the first b stores, the
// others add).
template <typename T, typename TB, int D>
__global__ void __launch_bounds__(NT) dq_dbias_kernel(const Params p) {
  constexpr int BK = Smem<D>::BK;
  constexpr int DPT = D / 16;
  constexpr int DP = Smem<D>::DP;
  constexpr int PP = Smem<D>::PP;
  extern __shared__ float smem[];
  const Smem<D> s(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (p.S_q + BQ - 1) / BQ;
  const int h = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int g = blockIdx.y;
  const int per = (p.B + p.G - 1) / p.G;
  const int b_lo = g * per;
  const int b_hi = min(p.B, b_lo + per);
  const int64_t head = static_cast<int64_t>(h) * p.S_q * p.S_k;
  const TB* bias = static_cast<const TB*>(p.bias) + head;
  float* dbias = p.dbias + static_cast<int64_t>(g) * p.H * p.S_q * p.S_k + head;
  const int nk = (p.S_k + BK - 1) / BK;

  for (int b = b_lo; b < b_hi; ++b) {
    __syncthreads();
    load_q_tile<T, D>(p, s, b, h, q0);
    float dq[RQ][DPT];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) dq[i][dd] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * BK;
      __syncthreads();
      load_k_tile<T, D>(p, s, b, h, k0);
      __syncthreads();
      p_and_ds<TB, D>(p, s, bias, q0, k0, dbias, b == b_lo);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float kv[DPT];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) kv[dd] = s.k[c * DP + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float dsv = s.ds[(ty * RQ + i) * PP + c];
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd) dq[i][dd] = fmaf(dsv, kv[dd], dq[i][dd]);
        }
      }
    }
    T* dq_out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      if (qi < p.S_q) {
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd)
          dq_out[qi * p.dq_ss + tx + 16 * dd] = from_f<T>(dq[i][dd] * p.scale);
      }
    }
  }
}

// out[i] = sum_g part[g, i], g in order.
__global__ void sum_groups_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int64_t n, int G) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += part[g * n + i];
    out[i] = acc;
  }
}

// ----------------------------------------------------- tensor-core pair

namespace tcb {

using namespace ::flash_tc;

constexpr int TILE_ROWS = 64;  // query rows and keys per tile (the logits tile)

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int C = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  static constexpr int TILE = TILE_ROWS * D * static_cast<int>(sizeof(T));  // one [64][D] tile
  static constexpr uint32_t SBO_T = (TILE_ROWS / 4) * 128;  // fp32 [D][64] transposed tile
  // [64][64] P^T / dS^T tile (fp32: hi and lo)
  static constexpr int PT = TILE_ROWS * TILE_ROWS * static_cast<int>(sizeof(T));
  static constexpr int SMEM_DQ = (F32 ? 10 : 4) * TILE;
  // fp32 keeps P^T hi and lo in the Q and dO tiles (hi and lo each), which
  // are free once S and dP are done: 2 * TILE >= PT at D >= 32
  static constexpr int SMEM_KV = F32 ? 12 * TILE : 4 * TILE + PT;
  static_assert(!F32 || 2 * TILE >= PT, "P^T must fit the Q tiles");
};

// the thread's accumulator rows of a tile: 16 w + g + 8 hh
__device__ __forceinline__ int frag_row(int hh) { return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * hh; }

// m, 1/l and delta of rows q0 + frag_row(hh) of (b, h); zeros past S_q
__device__ __forceinline__ void row_stats(const Params& p, int b, int h, int q0, float (&m)[2],
                                          float (&linv)[2], float (&delta)[2]) {
  const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.S_q;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + frag_row(hh);
    const bool in = qi < p.S_q;
    m[hh] = in ? p.m[row0 + qi] : 0.f;
    linv[hh] = in ? 1.f / p.l[row0 + qi] : 0.f;
    delta[hh] = in ? p.delta[row0 + qi] : 0.f;
  }
}

// the thread's bias pairs of the tile (q0, k0) of [S_q, S_k] row-major,
// bb[2 c + hh] at row frag_row(hh) and columns 8 c + 2 q + {0, 1}; zeros
// past the range.  Issued before the tile's loads are waited for.
template <typename TB>
__device__ __forceinline__ void bias_frag(float2 (&bb)[16], const TB* bias, const Params& p, int q0,
                                          int k0) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = q0 + frag_row(hh), kj = k0 + 8 * c + 2 * qd;
      float2 r = make_float2(0.f, 0.f);
      if (qi < p.S_q) {
        const TB* row = bias + static_cast<int64_t>(qi) * p.S_k;
        if (kj < p.S_k) r.x = to_f(row[kj]);
        if (kj + 1 < p.S_k) r.y = to_f(row[kj + 1]);
      }
      bb[2 * c + hh] = r;
    }
}

// S (logits) of a 64 x 64 tile into P in place, dP into dS in place:
// P = exp(x - m) / l, dS = P (dP - delta)
__device__ __forceinline__ void p_and_ds_regs(float (&s)[32], float (&dp)[32], const float (&m)[2],
                                              const float (&linv)[2], const float (&delta)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const float pv = exp2f((s[i] - m[hh]) * LOG2E) * linv[hh];
    s[i] = pv;
    dp[i] = pv * (dp[i] - delta[hh]);
  }
}

// dst (D/2 fp32 fragments of 64 x D) += A B with A the 64 x 64 fragments
// `x` in registers (rows as in the accumulator, K = its 64 columns) and B
// the [64][D] tile: fp32 B^T hi / lo at bt, bth (split_transpose_v
// layout), bf16 B at b (K-major core layout, read MN-major)
template <bool F32, int D>
__device__ __forceinline__ void rs_product(float (&dst)[D / 2], const float (&x)[32],
                                           const unsigned char* b, const unsigned char* bt,
                                           const unsigned char* btl) {
  constexpr int C = F32 ? D / 4 : D / 8;
  if constexpr (F32) {
    constexpr uint32_t SBO_T = (TILE_ROWS / 4) * 128;
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v[4] = {x[4 * c], x[4 * c + 2], x[4 * c + 1], x[4 * c + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[c][r] = tf32(v[r]);
        al[c][r] = tf32(v[r] - __uint_as_float(ah[c][r]));
      }
    }
    wg::fence();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint64_t bh = wg::desc(wg::smem_addr(bt + c * 256), 128, SBO_T);
      const uint64_t bl = wg::desc(wg::smem_addr(btl + c * 256), 128, SBO_T);
      wg::Mma<D>::rs_tf32(dst, ah[c], bh);
      wg::Mma<D>::rs_tf32(dst, ah[c], bl);
      wg::Mma<D>::rs_tf32(dst, al[c], bh);
    }
    wg::commit();
    wg::wait_all();
    fence_regs(ah);
    fence_regs(al);
  } else {
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::Mma<D>::rs_bf16_mn(dst, pa[kk], wg::desc(wg::smem_addr(b + kk * 2 * C * 128), C * 128, 128));
    wg::commit();
    wg::wait_all();
    fence_regs(pa);
  }
  wg::fence_regs(dst);
}

// x (64 x 64 fragments, rows = queries, columns = keys) into shared memory
// transposed, [key][query], as the K-major A operand of m64 x k(queries):
// fp32 hi at pt and lo at ptl with each query at tf32_pos (the permutation
// of split_transpose_v's B rows), bf16 at pt in natural order
template <bool F32>
__device__ __forceinline__ void store_transposed(const float (&x)[32], unsigned char* pt,
                                                 unsigned char* ptl) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rq = frag_row((i >> 1) & 1);
    const int kc = 8 * (i >> 2) + 2 * qd + (i & 1);
    if constexpr (F32) {
      const int pos = tf32_pos(rq);
      const int off = (((kc >> 3) * 16 + (pos >> 2)) * 8 + (kc & 7)) * 16 + (pos & 3) * 4;
      const uint32_t h = tf32(x[i]);
      *reinterpret_cast<uint32_t*>(pt + off) = h;
      *reinterpret_cast<uint32_t*>(ptl + off) = tf32(x[i] - __uint_as_float(h));
    } else {
      const int off = (((kc >> 3) * 8 + (rq >> 3)) * 8 + (kc & 7)) * 16 + (rq & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(pt + off) = __float2bfloat16(x[i]);
    }
  }
}

// dst (D/2 fp32 fragments of 64 keys x D) += A B with A the transposed
// tile at pt / ptl (store_transposed) and B the [64 queries][D] tile: fp32
// B^T hi / lo at bt, btl; bf16 B at b, read MN-major
template <bool F32, int D>
__device__ __forceinline__ void ss_product(float (&dst)[D / 2], const unsigned char* pt,
                                           const unsigned char* ptl, const unsigned char* b,
                                           const unsigned char* bt, const unsigned char* btl) {
  wg::fence();
  if constexpr (F32) {
    constexpr uint32_t SBO_T = (TILE_ROWS / 4) * 128;
#pragma unroll
    for (int ks = 0; ks < TILE_ROWS / 8; ++ks) {
      const uint64_t ah = wg::desc(wg::smem_addr(pt + ks * 256), 128, 16 * 128);
      const uint64_t al = wg::desc(wg::smem_addr(ptl + ks * 256), 128, 16 * 128);
      const uint64_t bh = wg::desc(wg::smem_addr(bt + ks * 256), 128, SBO_T);
      const uint64_t bl = wg::desc(wg::smem_addr(btl + ks * 256), 128, SBO_T);
      wg::Mma<D>::ss_tf32(dst, ah, bh);
      wg::Mma<D>::ss_tf32(dst, ah, bl);
      wg::Mma<D>::ss_tf32(dst, al, bh);
    }
  } else {
    constexpr int C = D / 8;
#pragma unroll
    for (int kk = 0; kk < TILE_ROWS / 16; ++kk)
      wg::Mma<D>::ss_bf16_mn(dst, wg::desc(wg::smem_addr(pt + kk * 256), 128, 8 * 128),
                             wg::desc(wg::smem_addr(b + kk * 2 * C * 128), C * 128, 128));
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(dst);
}

template <typename T>
__device__ __forceinline__ bool rows_async(const T* x, int64_t ld) {
  return aligned16(x) && (ld * static_cast<int64_t>(sizeof(T))) % 16 == 0;
}

// x (D/2 fragments of 64 rows x D) * scale into rows r0.. of out (row
// stride ld), rows below `valid` only
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, int64_t ld, int r0, int valid, const float (&x)[D / 2],
                                           float scale) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = frag_row(hh);
    if (r0 + r >= valid) continue;
    T* row = out + static_cast<int64_t>(r0 + r) * ld;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_pair(row + 8 * c + 2 * qd, x[4 * c + 2 * hh] * scale, x[4 * c + 2 * hh + 1] * scale);
  }
}

// grid (H * query tiles, G): dq of each b in the group, in order, and the
// group's dbias partial over its own query rows (the first b stores, the
// others add)
template <typename T, typename TB, int D>
__global__ void __launch_bounds__(NT) dq_dbias_tc(const Params p) {
  using K = Cfg<T, D>;
  constexpr bool F32 = K::F32;
  constexpr int C = K::C, TILE = K::TILE;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* sQ = smem_tc;
  unsigned char* sO = sQ + TILE;
  unsigned char* sK = sO + TILE;
  unsigned char* sV = sK + TILE;
  unsigned char* sQl = sV + TILE;  // fp32 only from here
  unsigned char* sOl = sQl + TILE;
  unsigned char* sKl = sOl + TILE;
  unsigned char* sVl = sKl + TILE;
  unsigned char* sKt = sVl + TILE;
  unsigned char* sKtl = sKt + TILE;
  const int qd = threadIdx.x & 3;
  const int nq = (p.S_q + TILE_ROWS - 1) / TILE_ROWS;
  const int h = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * TILE_ROWS;
  const int grp = blockIdx.y;
  const int per = (p.B + p.G - 1) / p.G;
  const int b_lo = grp * per;
  const int b_hi = min(p.B, b_lo + per);
  const int64_t head = static_cast<int64_t>(h) * p.S_q * p.S_k;
  const TB* bias = static_cast<const TB*>(p.bias) + head;
  float* dbias = p.dbias + static_cast<int64_t>(grp) * p.H * p.S_q * p.S_k + head;
  const int nk = (p.S_k + TILE_ROWS - 1) / TILE_ROWS;

  for (int b = b_lo; b < b_hi; ++b) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
    const T* dO = static_cast<const T*>(p.dO) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
    const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const bool k_async = rows_async(k, p.k_ss), v_async = rows_async(v, p.v_ss);
    __syncthreads();  // the previous sample's readers are done
    load_core<T, C>(sQ, q, p.q_ss, TILE_ROWS, p.S_q - q0, rows_async(q, p.q_ss));
    load_core<T, C>(sO, dO, p.do_ss, TILE_ROWS, p.S_q - q0, rows_async(dO, p.do_ss));
    float m[2], linv[2], delta[2];
    row_stats(p, b, h, q0, m, linv, delta);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * TILE_ROWS;
      if (t > 0) __syncthreads();  // the previous tile's readers are done
      load_core<T, C>(sK, k + k0 * p.k_ss, p.k_ss, TILE_ROWS, p.S_k - k0, k_async);
      load_core<T, C>(sV, v + k0 * p.v_ss, p.v_ss, TILE_ROWS, p.S_k - k0, v_async);
      cp_commit();
      // the bias and the group's dbias partial so far, in flight with the tiles
      float2 bb[16];
      bias_frag(bb, bias, p, q0, k0);
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = q0 + frag_row((i >> 1) & 1);
        const int kj = k0 + 8 * (i >> 2) + 2 * qd + (i & 1);
        part[i] = b > b_lo && qi < p.S_q && kj < p.S_k ? dbias[static_cast<int64_t>(qi) * p.S_k + kj] : 0.f;
      }
      cp_wait_all();
      __syncthreads();
      if constexpr (F32) {
        if (t == 0) {
          split_inplace(sQ, sQl, TILE);
          split_inplace(sO, sOl, TILE);
        }
        split_transpose_v<D, TILE_ROWS>(sK, sKt, sKtl);
        __syncthreads();  // raw K read
        split_inplace(sK, sKl, TILE);
        split_inplace(sV, sVl, TILE);
      }
      fence_async_smem();
      __syncthreads();

      float s[32], dp[32];
      logits<F32, D, TILE_ROWS>(s, sQ, sQl, sK, sKl, p.scale, p.S_k - k0, true, [] {},
                                [&](int c, int hh) { return bb[2 * c + hh]; });
      tile_product<F32, D, TILE_ROWS>(dp, sO, sOl, sV, sVl);
      p_and_ds_regs(s, dp, m, linv, delta);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = q0 + frag_row((i >> 1) & 1);
        const int kj = k0 + 8 * (i >> 2) + 2 * qd + (i & 1);
        if (qi < p.S_q && kj < p.S_k) dbias[static_cast<int64_t>(qi) * p.S_k + kj] = part[i] + dp[i];
      }
      rs_product<F32, D>(dq, dp, sK, sKt, sKtl);
    }
    T* dq_out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    store_rows<T, D>(dq_out, p.dq_ss, q0, p.S_q, dq, p.scale);
  }
}

// grid (B, H * key tiles), batch fastest: the B blocks of one (h, key
// tile) read the same bias columns from L2.  dk, dv of one key tile,
// looping over the query tiles.
template <typename T, typename TB, int D>
__global__ void __launch_bounds__(NT) dkdv_tc(const Params p) {
  using K = Cfg<T, D>;
  constexpr bool F32 = K::F32;
  constexpr int C = K::C, TILE = K::TILE;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // bf16: K, V, Q, dO, P^T; fp32: K, V, Q, dO hi and lo, Q^T and dO^T hi
  // and lo, with P^T hi over Q hi + lo and P^T lo over dO hi + lo
  unsigned char* sK = smem_tc;
  unsigned char* sV = sK + (F32 ? 2 : 1) * TILE;
  unsigned char* sQ = sV + (F32 ? 2 : 1) * TILE;
  unsigned char* sO = sQ + (F32 ? 2 : 1) * TILE;
  unsigned char* sKl = sK + TILE;
  unsigned char* sVl = sV + TILE;
  unsigned char* sQl = sQ + TILE;
  unsigned char* sOl = sO + TILE;
  unsigned char* sPt = F32 ? sQ : sO + TILE;
  unsigned char* sPtl = sO;
  unsigned char* sQt = sO + 2 * TILE;
  unsigned char* sQtl = sQt + TILE;
  unsigned char* sOt = sQtl + TILE;
  unsigned char* sOtl = sOt + TILE;
  const int b = blockIdx.x;
  const int nk = (p.S_k + TILE_ROWS - 1) / TILE_ROWS;
  const int h = blockIdx.y / nk;
  const int k0 = (blockIdx.y % nk) * TILE_ROWS;
  const TB* bias = static_cast<const TB*>(p.bias) + static_cast<int64_t>(h) * p.S_q * p.S_k;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dO) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + k0 * p.k_ss;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + k0 * p.v_ss;
  const bool q_async = rows_async(q, p.q_ss), o_async = rows_async(dO, p.do_ss);

  load_core<T, C>(sK, k, p.k_ss, TILE_ROWS, p.S_k - k0, rows_async(k, p.k_ss));
  load_core<T, C>(sV, v, p.v_ss, TILE_ROWS, p.S_k - k0, rows_async(v, p.v_ss));
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const int nq = (p.S_q + TILE_ROWS - 1) / TILE_ROWS;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * TILE_ROWS;
    if (t > 0) __syncthreads();  // the previous tile's readers are done
    load_core<T, C>(sQ, q + q0 * p.q_ss, p.q_ss, TILE_ROWS, p.S_q - q0, q_async);
    load_core<T, C>(sO, dO + q0 * p.do_ss, p.do_ss, TILE_ROWS, p.S_q - q0, o_async);
    cp_commit();
    float m[2], linv[2], delta[2];
    row_stats(p, b, h, q0, m, linv, delta);
    float2 bb[16];
    bias_frag(bb, bias, p, q0, k0);
    cp_wait_all();
    __syncthreads();
    if constexpr (F32) {
      if (t == 0) {
        split_inplace(sK, sKl, TILE);
        split_inplace(sV, sVl, TILE);
      }
      split_transpose_v<D, TILE_ROWS>(sQ, sQt, sQtl);
      split_transpose_v<D, TILE_ROWS>(sO, sOt, sOtl);
      __syncthreads();  // raw Q and dO read
      split_inplace(sQ, sQl, TILE);
      split_inplace(sO, sOl, TILE);
    }
    fence_async_smem();
    __syncthreads();

    float s[32], dp[32];
    logits<F32, D, TILE_ROWS>(s, sQ, sQl, sK, sKl, p.scale, p.S_k - k0, true, [] {},
                              [&](int c, int hh) { return bb[2 * c + hh]; });
    tile_product<F32, D, TILE_ROWS>(dp, sO, sOl, sV, sVl);
    p_and_ds_regs(s, dp, m, linv, delta);
    if constexpr (F32) __syncthreads();  // every warp's S and dP are done: Q and dO are free

    // dV += P^T dO
    store_transposed<F32>(s, sPt, sPtl);
    fence_async_smem();
    __syncthreads();
    ss_product<F32, D>(dv, sPt, sPtl, sO, sOt, sOtl);
    __syncthreads();  // every warp's wgmma has read P^T
    // dK += dS^T Q
    store_transposed<F32>(dp, sPt, sPtl);
    fence_async_smem();
    __syncthreads();
    ss_product<F32, D>(dk, sPt, sPtl, sQ, sQt, sQtl);
  }

  T* dk_out = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv_out = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T, D>(dk_out, p.dk_ss, k0, p.S_k, dk, p.scale);
  store_rows<T, D>(dv_out, p.dv_ss, k0, p.S_k, dv, 1.f);
}

}  // namespace tcb

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename TB, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  constexpr int BK = Smem<D>::BK;
  constexpr size_t smem = Smem<D>::floats * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = set_smem(dkdv_kernel<T, TB, D>, smem);
    if (e != cudaSuccess) return e;
    e = set_smem(dq_dbias_kernel<T, TB, D>, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid_kv(p.B * p.H, (p.S_k + BK - 1) / BK);
  dkdv_kernel<T, TB, D><<<grid_kv, NT, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid_q(p.H * ((p.S_q + BQ - 1) / BQ), p.G);
  dq_dbias_kernel<T, TB, D><<<grid_q, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TB, int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  using K = tcb::Cfg<T, D>;
  constexpr int R = tcb::TILE_ROWS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = set_smem(tcb::dkdv_tc<T, TB, D>, K::SMEM_KV);
    if (e != cudaSuccess) return e;
    e = set_smem(tcb::dq_dbias_tc<T, TB, D>, K::SMEM_DQ);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid_kv(p.B, p.H * ((p.S_k + R - 1) / R));
  tcb::dkdv_tc<T, TB, D><<<grid_kv, NT, K::SMEM_KV, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid_q(p.H * ((p.S_q + R - 1) / R), p.G);
  tcb::dq_dbias_tc<T, TB, D><<<grid_q, NT, K::SMEM_DQ, stream>>>(p);
  return cudaGetLastError();
}

// the tensor-core pair covers D = 32 and 64; D = 128 (whose dK and dV
// accumulators alone take 128 registers a thread, and whose fp32 tiles
// do not fit 227 KB) runs the SIMT pair
template <typename T, typename TB>
cudaError_t dispatch_d(int d, bool tc, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return tc ? launch_tc<T, TB, 32>(p, stream) : launch_simt<T, TB, 32>(p, stream);
    case 64: return tc ? launch_tc<T, TB, 64>(p, stream) : launch_simt<T, TB, 64>(p, stream);
    case 128: return tc ? cudaErrorInvalidValue : launch_simt<T, TB, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kern>
int occupancy(Kern kernel, int smem) {
  int n = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename T, typename TB>
int dq_blocks_d(int d, bool tc) {
  switch (d) {
    case 32: return tc ? occupancy(tcb::dq_dbias_tc<T, TB, 32>, tcb::Cfg<T, 32>::SMEM_DQ)
                       : occupancy(dq_dbias_kernel<T, TB, 32>, Smem<32>::floats * 4);
    case 64: return tc ? occupancy(tcb::dq_dbias_tc<T, TB, 64>, tcb::Cfg<T, 64>::SMEM_DQ)
                       : occupancy(dq_dbias_kernel<T, TB, 64>, Smem<64>::floats * 4);
    case 128: return tc ? 0 : occupancy(dq_dbias_kernel<T, TB, 128>, Smem<128>::floats * 4);
    default: return 0;
  }
}

}  // namespace

// Blocks of the dq/dbias kernel that one SM holds at once (0: no such
// kernel), for the caller's choice of batch groups.  Codes as flash_bwd's.
extern "C" int flash_bwd_dq_blocks_per_sm(int dtype, int bias_dtype, int d, int tc) {
  const bool t = tc != 0;
  if (dtype == 0 && bias_dtype == 0) return dq_blocks_d<float, float>(d, t);
  if (dtype == 0 && bias_dtype == 1) return dq_blocks_d<float, __nv_bfloat16>(d, t);
  if (dtype == 1 && bias_dtype == 0) return dq_blocks_d<__nv_bfloat16, float>(d, t);
  if (dtype == 1 && bias_dtype == 1) return dq_blocks_d<__nv_bfloat16, __nv_bfloat16>(d, t);
  return 0;
}

// dtype codes: 0 = float32, 1 = bfloat16.  q/k/v/dO/dq/dk/dv are
// [B, H, S, D] with any strides (elements) and a contiguous D axis; bias is
// [H, S_q, S_k] contiguous; m, l, delta are fp32 [B, H, S_q] contiguous.
// `dbias_part` is fp32 [G, H, S_q, S_k] scratch when G > 1, else the
// output itself; `dbias` is the fp32 [H, S_q, S_k] output.  `tc` = 1 runs
// the tensor-core pair (m and l from flash_fwd_tc), 0 the SIMT pair (m and
// l from the SIMT forward).  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int flash_bwd(
    int dtype, int bias_dtype, int d,
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    const void* dO, int64_t do_sb, int64_t do_sh, int64_t do_ss,
    const void* bias, const float* m, const float* l, const float* delta,
    void* dq, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
    void* dk, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
    void* dv, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
    float* dbias_part, float* dbias,
    int B, int H, int S_q, int S_k, int G, float scale, void* stream, int tc) {
  // every group of ceil(B / G) consecutive samples must be non-empty: a
  // block writes its dbias partial only from the samples it walks
  if (B <= 0 || H <= 0 || S_q <= 0 || S_k <= 0 || G <= 0 || (G - 1) * ((B + G - 1) / G) >= B)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dO, bias, m, l, delta, dq, dk, dv, G == 1 ? dbias : dbias_part,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
           dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           B, H, S_q, S_k, G, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = tc != 0;
  cudaError_t e;
  if (dtype == 0 && bias_dtype == 0) e = dispatch_d<float, float>(d, t, p, s);
  else if (dtype == 0 && bias_dtype == 1) e = dispatch_d<float, __nv_bfloat16>(d, t, p, s);
  else if (dtype == 1 && bias_dtype == 0) e = dispatch_d<__nv_bfloat16, float>(d, t, p, s);
  else if (dtype == 1 && bias_dtype == 1) e = dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, t, p, s);
  else e = cudaErrorInvalidValue;
  if (e != cudaSuccess || G == 1) return static_cast<int>(e);
  const int64_t n = static_cast<int64_t>(H) * S_q * S_k;
  const int blocks = static_cast<int>((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  sum_groups_kernel<<<blocks, 256, 0, s>>>(p.dbias, dbias, n, G);
  return static_cast<int>(cudaGetLastError());
}
