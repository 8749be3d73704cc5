// Flash-attention forward with an additive bias, for Hopper (sm_90a).
//
//   o[b, h, i, :] = softmax_j(q[b,h,i,:] . k[b,h,j,:] / sqrt(D) + bias[(b*H + h) % lead, i, j]) @ v[b,h,j,:]
//
// One kernel serves the five forward Pallas kernels of the JAX package
// (physdock_tpu/ops/flash_attention.py::flash_sdpa,
//  flash_attention_grouped.py::flash_sdpa_grouped,
//  flash_attention_folded.py::flash_sdpa_folded,
//  flash_attention_folded_v3.py::flash_sdpa_folded_v3,
//  flash_attention_bwd.py::flash_fwd_lse).  On the TPU they
// differ only in how heads are folded into lanes and how samples are
// grouped around VMEM; here the split [B, H, S, D] and folded [B, S, H*D]
// layouts are both just strides, and a bias shared over B is the
// `(b*H + h) % lead` row-block index (lead = H gives a sample stride of 0).
// flash_fwd_lse is the same kernel with two more outputs: given `m` and
// `l` pointers, it stores each query row's fp32 running max and softmax
// normalizer separately ([B, H, S_q], contiguous), never fused as
// lse = m + log(l), which loses log(l) below ulp(1e9) on masked rows.
//
// Design (simple first): one block of 128 threads per (b, h, 64-row query
// tile); the keys stream through shared memory in 64-row tiles with an
// online softmax whose running max and sum are fp32.  Inputs in fp32 or
// bf16 are widened to fp32 on load and every product is an fp32 FMA on the
// CUDA cores, so the fp32 path matches the plain PyTorch version to
// rounding.  The bias is added as given: a -1e9 / -2e9 mask entry is an
// ordinary logit, so a fully masked row softmaxes over its bias exactly as
// the einsum reference does.  Keys past S_k (the ragged last tile) get
// -inf; query rows past S_q are computed on zeros and not stored.
//
// Bound on this card: at the atom-DiT shape (B=20, H=4, S=2048, D=32) the
// work is 4*B*H*S^2*D = 43 GFLOP against ~0.2 GB of traffic, so the fp32
// CUDA-core rate bounds it; this kernel issues two shared-memory loads per
// three FMAs, and wgmma/TMA tiles are the next step.
//
// Plain C interface, bound with ctypes (physdock_tpu_torch/ops/_flash_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block: 16 (tx) x 8 (ty)
constexpr int RPT = BQ / 8;   // query rows per thread
constexpr int CPT = BK / 16;  // key columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, typename TB, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
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

template <typename T, typename TB>
cudaError_t dispatch_d(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, TB, 32>(p, stream);
    case 64: return launch<T, TB, 64>(p, stream);
    case 128: return launch<T, TB, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements; the
// last (head-dim / key) axis of every tensor is contiguous.  `m` and `l`
// are null (forward only) or fp32 [B, H, S_q] contiguous (forward with
// stats).  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(
    int dtype, int bias_dtype, int d,
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float* m, float* l,
    const void* bias, int64_t b_sl, int64_t b_ss, int lead,
    int B, int H, int S_q, int S_k, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S_q <= 0) return 0;
  if (S_k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, bias, o, m, l,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           b_sl, b_ss, B, H, S_q, S_k, lead, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && bias_dtype == 0) e = dispatch_d<float, float>(d, p, s);
  else if (dtype == 0 && bias_dtype == 1) e = dispatch_d<float, __nv_bfloat16>(d, p, s);
  else if (dtype == 1 && bias_dtype == 0) e = dispatch_d<__nv_bfloat16, float>(d, p, s);
  else if (dtype == 1 && bias_dtype == 1) e = dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, p, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
