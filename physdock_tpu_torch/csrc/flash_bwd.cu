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
// Design (simple first, as flash_fwd.cu): SIMT fp32 on the CUDA cores,
// 128 threads (16 x 8) per block, tiles of 64 query rows and 64 keys (32
// keys at D = 128 to stay inside the registers), inputs widened to fp32 on
// load.  Rows past S_q and keys past S_k get P = 0.
//
// Bound on this card: at the atom-DiT training shape (B=48, H=4, S=2048,
// D=32) the five products are 10*B*H*S^2*D = 258 GFLOP against ~0.3 GB of
// traffic, so the fp32 CUDA-core rate bounds it (>= 3.85 ms at 67 TFLOP/s);
// the two kernels recompute S and dP, 7 products in all.  Tensor-core tiles
// (wgmma) are the next step.
//
// Plain C interface, bound with ctypes (physdock_tpu_torch/ops/_flash_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block: 16 (tx) x 8 (ty)
constexpr int BQ = 64;       // query rows per tile
constexpr int RQ = BQ / 8;   // query rows per thread in the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename TB, int D>
cudaError_t launch(const Params& p, float* dbias_out, cudaStream_t stream) {
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
  e = cudaGetLastError();
  if (e != cudaSuccess || p.G == 1) return e;
  const int64_t n = static_cast<int64_t>(p.H) * p.S_q * p.S_k;
  const int blocks = static_cast<int>((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  sum_groups_kernel<<<blocks, 256, 0, stream>>>(p.dbias, dbias_out, n, p.G);
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t dispatch_d(int d, const Params& p, float* dbias_out, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, TB, 32>(p, dbias_out, stream);
    case 64: return launch<T, TB, 64>(p, dbias_out, stream);
    case 128: return launch<T, TB, 128>(p, dbias_out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q/k/v/dO/dq/dk/dv are
// [B, H, S, D] with any strides (elements) and a contiguous D axis; bias is
// [H, S_q, S_k] contiguous; m, l, delta are fp32 [B, H, S_q] contiguous.
// `dbias_part` is fp32 [G, H, S_q, S_k] scratch when G > 1, else the
// output itself; `dbias` is the fp32 [H, S_q, S_k] output.  Returns the
// cudaError_t of the launches (0 = success).
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
    int B, int H, int S_q, int S_k, int G, float scale, void* stream) {
  // every group of ceil(B / G) consecutive samples must be non-empty: a
  // block writes its dbias partial only from the samples it walks
  if (B <= 0 || H <= 0 || S_q <= 0 || S_k <= 0 || G <= 0 || (G - 1) * ((B + G - 1) / G) >= B)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dO, bias, m, l, delta, dq, dk, dv, G == 1 ? dbias : dbias_part,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
           dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           B, H, S_q, S_k, G, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && bias_dtype == 0) e = dispatch_d<float, float>(d, p, dbias, s);
  else if (dtype == 0 && bias_dtype == 1) e = dispatch_d<float, __nv_bfloat16>(d, p, dbias, s);
  else if (dtype == 1 && bias_dtype == 0) e = dispatch_d<__nv_bfloat16, float>(d, p, dbias, s);
  else if (dtype == 1 && bias_dtype == 1) e = dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, p, dbias, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
