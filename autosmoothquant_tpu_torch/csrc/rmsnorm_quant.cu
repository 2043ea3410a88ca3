// RMSNorm (+ int8 quantize), one block per row: the first norm of a Llama
// decoder layer with the int8 cast that feeds q|k|v, and the final norm.
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/common.py:32 rms_norm, followed by
// autosmoothquant_tpu/quant/math.py:115 quantize_act_prescaled:
//
//   y = x * (1 / sqrt(mean(x^2) + eps)) * gamma      (f32)
//   q = clamp(round_half_even(y), -128, 127)         (int8; or y in x's dtype)
//
// gamma carries the folded per-tensor input scale, so q feeds the q|k|v
// int8 GEMM directly. It is K2 (add_rmsnorm_quant.cu) without the residual
// add: the same vector design (the row in registers, V chunks of 8 a thread,
// every load issued first, one warp-shuffle + shared-memory reduction) and
// the same arithmetic rules: every product and sum an explicit
// round-to-nearest intrinsic (no FMA contraction), 1 / sqrtf, rintf.
//
// Batch invariance: a row's reduction order is set by D alone (the thread
// that owns each chunk, then the warp tree, then the warps in order), never
// by the number of rows, so a row's bits are the same in any batch.
// kernels/fused.py:rmsnorm_quant_ordered adds in this order too and is
// bit-equal to the kernel; the plain version (rmsnorm_quant_plain, torch's
// mean, as the two ops it fuses ran) may put a value one int8 step away
// where it lies within a last bit of a rounding boundary.
//
// What bounds it on an H100: bytes. A row reads x (and gamma) once and
// writes q or y once: D = 2048 bf16 is 6 KB a row, a few nanoseconds at 3.35
// TB/s; at decode (1-16 rows) the time is the launch and one round trip to
// device memory.

#include <type_traits>

#include "asq_common.cuh"

namespace {

template <typename T, typename Out, int V>
__global__ void __launch_bounds__(kAsqRowMaxThreads)
    rmsnorm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         Out* __restrict__ out, int D, float eps) {
  __shared__ float part[kAsqRowMaxThreads / 32];
  const int chunks = D / 8;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float xv[V][8], gm[V][8];
  bool on[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {  // every load first
    const int c = threadIdx.x + v * blockDim.x;
    on[v] = c < chunks;
    if (on[v]) {
      asq_load8(x + base + 8 * c, xv[v]);
      asq_load8(gamma + 8 * c, gm[v]);
    }
  }
  float local = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) local = __fadd_rn(local, __fmul_rn(xv[v][e], xv[v][e]));
  }
  const float total = asq_block_sum(local, part);
  const float inv = 1.f / sqrtf(__fadd_rn(total / static_cast<float>(D), eps));
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!on[v]) continue;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __fmul_rn(__fmul_rn(xv[v][e], inv), gm[v][e]);
    Out* o = out + base + 8 * (threadIdx.x + v * blockDim.x);
    if constexpr (std::is_same_v<Out, int8_t>) {
      asq_store8_int8(o, y);
    } else {
      asq_store8(o, y);
    }
  }
}

template <typename T, typename Out>
int launch(const void* x, const void* gamma, void* out, int rows, int D, float eps,
           cudaStream_t s) {
  const auto [V, threads] = asq_row_shape(D);
  const auto xp = static_cast<const T*>(x);
  const auto gp = static_cast<const float*>(gamma);
  const auto op = static_cast<Out*>(out);
  if (V == 1) {
    rmsnorm_quant_kernel<T, Out, 1><<<rows, threads, 0, s>>>(xp, gp, op, D, eps);
  } else if (V == 2) {
    rmsnorm_quant_kernel<T, Out, 2><<<rows, threads, 0, s>>>(xp, gp, op, D, eps);
  } else {
    rmsnorm_quant_kernel<T, Out, 3><<<rows, threads, 0, s>>>(xp, gp, op, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, D] in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); gamma [D] f32;
// out [rows, D]: int8 (quantize = 1) or x's dtype (quantize = 0). Needs
// D % 8 == 0, D <= 12288 and 16-byte aligned x, gamma and out.
ASQ_EXPORT int asq_rmsnorm_quant(const void* x, const void* gamma, void* out, int rows,
                                 int D, float eps, int is_bf16, int quantize,
                                 void* stream) {
  if (!asq_row_vec_ok(D, {x, gamma, out})) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (is_bf16) {
    return quantize ? launch<__nv_bfloat16, int8_t>(x, gamma, out, rows, D, eps, s)
                    : launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rows, D, eps, s);
  }
  return quantize ? launch<float, int8_t>(x, gamma, out, rows, D, eps, s)
                  : launch<float, float>(x, gamma, out, rows, D, eps, s);
}
