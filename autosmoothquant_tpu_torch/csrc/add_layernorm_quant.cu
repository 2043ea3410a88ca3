// K6: fused residual add + LayerNorm + int8 quantize (the OPT family's
// pre-LN block), one block per row.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/fused.py:
// _add_layernorm_quant_kernel (pallas_call in fused_add_layernorm_quant):
//
//   s = h + x                     (f32 sum, written back in h's dtype)
//   c = s - mean(s)
//   y = c * (1 / sqrt(mean(c^2) + eps)) * gamma + beta      (f32)
//   q = clamp(round_half_even(y), -128, 127)                (int8)
//
// gamma and beta both carry the folded per-tensor input scale, so q feeds
// the fc1 GEMM directly.
//
// What bounds it on an H100: bytes. Per row it reads h and x and writes s and
// q once (D = 4096 bf16: 28 KB a row) and does ~10 operations per element; at
// decode (one row) the bound is almost nil and the time is latency: the
// launch, one round trip to device memory and the block's reductions.
//
// The variance is two-pass: the block first reduces sum(s) for the mean,
// then sum((s - mean)^2). OPT's activations carry outlier channels and a
// large common offset, where the one-pass E[s^2] - mean^2 cancels and would
// move q by many steps. Every product and sum is an explicit round-to-nearest
// intrinsic (no FMA contraction), the inverse root is correctly rounded
// (asq_rsqrt_rn, the plain version's bits) rather than rsqrtf, and rounding
// is half to even (rintf), which keeps q within one step of the plain version
// where rounding ties are close. Two routes, chosen by the wrapper from the shape
// (kernels/fused.py:norm_route, shared with K2):
//  - vector (D % 8 == 0, 16-byte aligned operands, D <= 12288): the row
//    lives in registers. A thread owns V chunks of 8 elements (V = 1..3,
//    a template; up to 512 threads; the last chunks predicated). It issues
//    every load at its start, h and x as 16-byte vectors (bf16; two for
//    f32) together with gamma and beta (float4s), so one round trip to
//    device memory serves them all. The mean and the centred squares come
//    from the registers, each reduction a warp shuffle plus one exchange
//    through shared memory (two barriers in all), and s and q leave as
//    vector stores. There is no shared copy of the row.
//  - rows (any other D): 256 threads keep the row of s in shared memory (f32,
//    so the norm sees the unrounded sum; D = 4096 is 16 KB) and sweep it
//    three times.

#include "asq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The block's sum of v, returned to every thread. `part` (kWarps floats of
// shared memory) may be reused by the next call.
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = asq_warp_sum(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, part[w]);
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_layernorm_quant_kernel(const T* __restrict__ h, const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               T* __restrict__ out_h, int8_t* __restrict__ out_q,
                               int D, float eps) {
  extern __shared__ float s_row[];  // [D]
  __shared__ float part[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float local = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float s = __fadd_rn(asq_to_float(h[base + i]), asq_to_float(x[base + i]));
    s_row[i] = s;
    out_h[base + i] = asq_from_float<T>(s);
    local = __fadd_rn(local, s);
  }
  const float mean = block_sum(local, part) / static_cast<float>(D);
  local = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = __fsub_rn(s_row[i], mean);
    local = __fadd_rn(local, __fmul_rn(c, c));
  }
  const float var = block_sum(local, part) / static_cast<float>(D);
  const float inv = asq_rsqrt_rn(__fadd_rn(var, eps));
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = __fsub_rn(s_row[i], mean);
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gamma[i]), beta[i]);
    out_q[base + i] = asq_quant_int8(y);
  }
}

// ---------------------------------------------------------------------------
// vector: the row in registers
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kAsqRowMaxThreads)
    add_layernorm_quant_vec_kernel(const T* __restrict__ h, const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, T* __restrict__ out_h,
                                   int8_t* __restrict__ out_q, int D, float eps) {
  __shared__ float part[2][kAsqRowMaxThreads / 32];
  const int chunks = D / 8;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float hv[V][8], xv[V][8], gm[V][8], bt[V][8];
  bool on[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {  // every load first
    const int c = threadIdx.x + v * blockDim.x;
    on[v] = c < chunks;
    if (on[v]) {
      asq_load8(h + base + 8 * c, hv[v]);
      asq_load8(x + base + 8 * c, xv[v]);
      asq_load8(gamma + 8 * c, gm[v]);
      asq_load8(beta + 8 * c, bt[v]);
    }
  }
  float local = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hv[v][e] = __fadd_rn(hv[v][e], xv[v][e]);  // s, in place of h
      local = __fadd_rn(local, hv[v][e]);
    }
    asq_store8(out_h + base + 8 * (threadIdx.x + v * blockDim.x), hv[v]);
  }
  const float mean = asq_block_sum(local, part[0]) / static_cast<float>(D);
  local = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = __fsub_rn(hv[v][e], mean);
      local = __fadd_rn(local, __fmul_rn(c, c));
    }
  }
  const float var = asq_block_sum(local, part[1]) / static_cast<float>(D);
  const float inv = asq_rsqrt_rn(__fadd_rn(var, eps));
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = __fsub_rn(hv[v][e], mean);
      y[e] = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gm[v][e]), bt[v][e]);
    }
    asq_store8_int8(out_q + base + 8 * (threadIdx.x + v * blockDim.x), y);
  }
}

template <typename T>
int launch_vec(const void* h, const void* x, const void* gamma, const void* beta,
               void* out_h, void* out_q, int rows, int D, float eps, cudaStream_t s) {
  const auto [V, threads] = asq_row_shape(D);
  const auto hp = static_cast<const T*>(h);
  const auto xp = static_cast<const T*>(x);
  const auto gp = static_cast<const float*>(gamma);
  const auto bp = static_cast<const float*>(beta);
  const auto oh = static_cast<T*>(out_h);
  const auto oq = static_cast<int8_t*>(out_q);
  if (V == 1) {
    add_layernorm_quant_vec_kernel<T, 1><<<rows, threads, 0, s>>>(hp, xp, gp, bp, oh, oq, D, eps);
  } else if (V == 2) {
    add_layernorm_quant_vec_kernel<T, 2><<<rows, threads, 0, s>>>(hp, xp, gp, bp, oh, oq, D, eps);
  } else {
    add_layernorm_quant_vec_kernel<T, 3><<<rows, threads, 0, s>>>(hp, xp, gp, bp, oh, oq, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rows: the row of s in shared memory
// ---------------------------------------------------------------------------

template <typename T>
int launch(const void* h, const void* x, const void* gamma, const void* beta,
           void* out_h, void* out_q, int rows, int D, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem + sizeof(float) * kWarps > 48 * 1024) {  // the row beside the static part
    cudaFuncSetAttribute(add_layernorm_quant_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  add_layernorm_quant_kernel<T><<<rows, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(out_h), static_cast<int8_t*>(out_q), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, x, out_h [rows, D] in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gamma, beta [D] f32; out_q [rows, D] int8. The rows route.
ASQ_EXPORT int asq_add_layernorm_quant(const void* h, const void* x,
                                       const void* gamma, const void* beta,
                                       void* out_h, void* out_q, int rows, int D,
                                       float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  return is_bf16
             ? launch<__nv_bfloat16>(h, x, gamma, beta, out_h, out_q, rows, D, eps, s)
             : launch<float>(h, x, gamma, beta, out_h, out_q, rows, D, eps, s);
}

// The vector route: arguments as asq_add_layernorm_quant. Needs D % 8 == 0,
// D <= 12288 and 16-byte aligned h, x, gamma, beta, out_h and out_q.
ASQ_EXPORT int asq_add_layernorm_quant_vec(const void* h, const void* x,
                                           const void* gamma, const void* beta,
                                           void* out_h, void* out_q, int rows, int D,
                                           float eps, int is_bf16, void* stream) {
  if (!asq_row_vec_ok(D, {h, x, gamma, beta, out_h, out_q}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  return is_bf16
             ? launch_vec<__nv_bfloat16>(h, x, gamma, beta, out_h, out_q, rows, D, eps, s)
             : launch_vec<float>(h, x, gamma, beta, out_h, out_q, rows, D, eps, s);
}
