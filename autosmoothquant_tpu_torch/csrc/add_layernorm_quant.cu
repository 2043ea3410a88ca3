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
// q once (D = 4096 bf16: 28 KB a row) and does ~10 operations per element.
//
// Design, as K2 (add_rmsnorm_quant.cu) with a second reduction: one block of
// 256 threads per row keeps its row of s in shared memory (f32, so the norm
// sees the unrounded sum, as the JAX kernel does; D = 4096 is 16 KB). The
// variance is two-pass: the block first reduces sum(s) for the mean, then
// sweeps the shared copy again for sum((s - mean)^2). OPT's activations carry
// outlier channels and a large common offset, where the one-pass
// E[s^2] - mean^2 cancels and would move q by many steps. Every product and
// sum is an explicit round-to-nearest intrinsic (no FMA contraction), the
// inverse root is 1 / sqrtf (both correctly rounded) rather than rsqrtf, and
// rounding is half to even (rintf), which keeps q within one step of the
// plain version where rounding ties are close.

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
  const float inv = 1.f / sqrtf(__fadd_rn(var, eps));
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = __fsub_rn(s_row[i], mean);
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gamma[i]), beta[i]);
    out_q[base + i] = asq_quant_int8(y);
  }
}

template <typename T>
int launch(const void* h, const void* x, const void* gamma, const void* beta,
           void* out_h, void* out_q, int rows, int D, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
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
// gamma, beta [D] f32; out_q [rows, D] int8.
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
