// K2: fused residual add + RMSNorm + int8 quantize, one block per row.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/fused.py:
// _add_rmsnorm_quant_kernel (pallas_call in fused_add_rmsnorm_quant):
//
//   s = h + x                     (f32 sum, written back in h's dtype)
//   y = s * (1 / sqrt(mean(s^2) + eps)) * gamma      (f32)
//   q = clamp(round_half_even(y), -128, 127)         (int8)
//
// gamma carries the folded per-tensor input scale, so q feeds the next int8
// GEMM directly.
//
// What bounds it on an H100: bytes. Per row it reads h and x and writes s and
// q once (D = 2048 bf16: 14 KB a row) and does ~5 operations per element; at
// decode (one row) the bound is almost nil and the time is latency: the
// launch, one round trip to device memory and the block's reduction.
//
// Every product and sum is an explicit round-to-nearest intrinsic (no FMA
// contraction), the inverse root is 1 / sqrtf (both correctly rounded) rather
// than rsqrtf, and rounding is half to even (rintf), which keeps q within one
// step of the plain version where rounding ties are close. The norm sees the
// unrounded f32 sum, as the JAX kernel does. Two routes, chosen by the
// wrapper from the shape (kernels/fused.py:norm_route), the design of K6's
// (add_layernorm_quant.cu) with one reduction instead of two:
//  - vector (D % 8 == 0, 16-byte aligned operands, D <= 12288): the row
//    lives in registers. A thread owns V chunks of 8 elements (V = 1..3, a
//    template; up to 512 threads; the last chunks predicated). It issues
//    every load at its start, h and x as 16-byte vectors (bf16; two for f32)
//    together with gamma (float4s), so one round trip to device memory serves
//    them all. Then s = h + x leaves as vector stores, sum(s^2) is a warp
//    shuffle plus one exchange through shared memory (one barrier), and q
//    leaves as 8-byte stores. There is no shared copy of the row.
//  - rows (any other D): 256 threads keep the row of s in shared memory and
//    sweep it twice; gamma is read after the reduction.

#include "asq_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_quant_kernel(const T* __restrict__ h, const T* __restrict__ x,
                             const float* __restrict__ gamma, T* __restrict__ out_h,
                             int8_t* __restrict__ out_q, int D, float eps) {
  extern __shared__ float s_row[];  // [D]
  __shared__ float warp_part[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float local = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float s = __fadd_rn(asq_to_float(h[base + i]), asq_to_float(x[base + i]));
    s_row[i] = s;
    out_h[base + i] = asq_from_float<T>(s);
    local = __fadd_rn(local, __fmul_rn(s, s));
  }
  local = asq_warp_sum(local);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = local;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_part[w];
  const float inv = 1.f / sqrtf(total / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float y = __fmul_rn(__fmul_rn(s_row[i], inv), gamma[i]);
    out_q[base + i] = asq_quant_int8(y);
  }
}

template <typename T>
int launch(const void* h, const void* x, const void* gamma, void* out_h,
           void* out_q, int rows, int D, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(add_rmsnorm_quant_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  add_rmsnorm_quant_kernel<T><<<rows, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(x),
      static_cast<const float*>(gamma), static_cast<T*>(out_h),
      static_cast<int8_t*>(out_q), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// vector: the row in registers
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kAsqRowMaxThreads)
    add_rmsnorm_quant_vec_kernel(const T* __restrict__ h, const T* __restrict__ x,
                                 const float* __restrict__ gamma, T* __restrict__ out_h,
                                 int8_t* __restrict__ out_q, int D, float eps) {
  __shared__ float part[kAsqRowMaxThreads / 32];
  const int chunks = D / 8;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float hv[V][8], xv[V][8], gm[V][8];
  bool on[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {  // every load first
    const int c = threadIdx.x + v * blockDim.x;
    on[v] = c < chunks;
    if (on[v]) {
      asq_load8(h + base + 8 * c, hv[v]);
      asq_load8(x + base + 8 * c, xv[v]);
      asq_load8(gamma + 8 * c, gm[v]);
    }
  }
  float local = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hv[v][e] = __fadd_rn(hv[v][e], xv[v][e]);  // s, in place of h
      local = __fadd_rn(local, __fmul_rn(hv[v][e], hv[v][e]));
    }
    asq_store8(out_h + base + 8 * (threadIdx.x + v * blockDim.x), hv[v]);
  }
  const float total = asq_block_sum(local, part);
  const float inv = 1.f / sqrtf(__fadd_rn(total / static_cast<float>(D), eps));
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __fmul_rn(__fmul_rn(hv[v][e], inv), gm[v][e]);
    asq_store8_int8(out_q + base + 8 * (threadIdx.x + v * blockDim.x), y);
  }
}

template <typename T>
int launch_vec(const void* h, const void* x, const void* gamma, void* out_h, void* out_q,
               int rows, int D, float eps, cudaStream_t s) {
  const auto [V, threads] = asq_row_shape(D);
  const auto hp = static_cast<const T*>(h);
  const auto xp = static_cast<const T*>(x);
  const auto gp = static_cast<const float*>(gamma);
  const auto oh = static_cast<T*>(out_h);
  const auto oq = static_cast<int8_t*>(out_q);
  if (V == 1) {
    add_rmsnorm_quant_vec_kernel<T, 1><<<rows, threads, 0, s>>>(hp, xp, gp, oh, oq, D, eps);
  } else if (V == 2) {
    add_rmsnorm_quant_vec_kernel<T, 2><<<rows, threads, 0, s>>>(hp, xp, gp, oh, oq, D, eps);
  } else {
    add_rmsnorm_quant_vec_kernel<T, 3><<<rows, threads, 0, s>>>(hp, xp, gp, oh, oq, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, x, out_h [rows, D] in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gamma [D] f32; out_q [rows, D] int8. The rows route.
ASQ_EXPORT int asq_add_rmsnorm_quant(const void* h, const void* x,
                                     const void* gamma, void* out_h, void* out_q,
                                     int rows, int D, float eps, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(h, x, gamma, out_h, out_q, rows, D, eps, s)
                 : launch<float>(h, x, gamma, out_h, out_q, rows, D, eps, s);
}

// The vector route: arguments as asq_add_rmsnorm_quant. Needs D % 8 == 0,
// D <= 12288 and 16-byte aligned h, x, gamma, out_h and out_q.
ASQ_EXPORT int asq_add_rmsnorm_quant_vec(const void* h, const void* x,
                                         const void* gamma, void* out_h, void* out_q,
                                         int rows, int D, float eps, int is_bf16,
                                         void* stream) {
  if (!asq_row_vec_ok(D, {h, x, gamma, out_h, out_q}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  return is_bf16 ? launch_vec<__nv_bfloat16>(h, x, gamma, out_h, out_q, rows, D, eps, s)
                 : launch_vec<float>(h, x, gamma, out_h, out_q, rows, D, eps, s);
}
