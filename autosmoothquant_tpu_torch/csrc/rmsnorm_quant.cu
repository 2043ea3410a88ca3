// RMSNorm (+ int8 quantize), one block per row, with the residual add before
// it folded in: every RMSNorm of the Llama, Gemma, Baichuan and Mixtral
// forwards that K2 (add_rmsnorm_quant.cu) does not run, each in one launch
// (those before int4 projections stay torch ops: models/common.py:norm_dtype).
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/common.py:32 rms_norm, followed by
// autosmoothquant_tpu/quant/math.py:115 quantize_act_prescaled, and the
// residual add before the norm (autosmoothquant_tpu/models/llama.py:234 and
// :284, baichuan.py:230 and :251, mixtral.py:509 and its layer's return):
//
//   s = round_to_T(x + r)                            (with r: the new stream)
//   y = s * (1 / sqrt(mean(s^2) + eps)) * gamma      (f32, from the ROUNDED s)
//   out = clamp(round_half_even(y), -128, 127)       (int8), or y in f32 or bf16
//
// With r the kernel writes s too, to its own tensor. The norm reads s after
// its rounding to x's dtype, as the XLA boundary it replaces does (XLA adds
// in bf16, then the next layer's norm reads the bf16 sum); K2, after JAX's
// Pallas kernel, normalises the unrounded f32 sum instead, so the two are not
// interchangeable. Without r it is the norm of x itself.
//
// gamma carries the folded per-tensor input scale where out is int8, so q
// feeds an int8 GEMM directly. f32 out is rms_norm's own dtype (what the fp8
// and per-token quantizers and Mixtral's router read); bf16 out is the same
// f32 y rounded once, for a bf16 GEMM whose first op would be that cast.
// The design is K2's vector design (the row in registers, V chunks of 8 a
// thread, every load issued first, one warp-shuffle + shared-memory
// reduction) and its arithmetic rules: every product and sum an explicit
// round-to-nearest intrinsic (no FMA contraction), 1 / sqrtf, rintf.
//
// Batch invariance: a row's reduction order is set by D alone (the thread
// that owns each chunk, then the warp tree, then the warps in order), never
// by the number of rows, so a row's bits are the same in any batch.
// chip_smoke.py:rmsnorm_quant_ordered adds in this order too and is
// bit-equal to the kernel; the plain version (rmsnorm_quant_plain, torch's
// mean, as the ops it fuses ran) may put a value one int8 step away where it
// lies within a last bit of a rounding boundary.
//
// What bounds it on an H100: bytes. A row reads x (r and gamma) once and
// writes s and out once: D = 2048 bf16 is 6-14 KB a row, a few nanoseconds at
// 3.35 TB/s; at decode (1-16 rows) the time is the launch and one round trip
// to device memory, which is why the add rides in the same launch.

#include <type_traits>

#include "asq_common.cuh"

namespace {

// v rounded to T's precision and widened back (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return asq_to_float(asq_from_float<T>(v));
}

template <typename T, typename Out, int V, bool Res>
__global__ void __launch_bounds__(kAsqRowMaxThreads)
    rmsnorm_quant_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const float* __restrict__ gamma, T* __restrict__ s_out,
                         Out* __restrict__ out, int D, float eps) {
  __shared__ float part[kAsqRowMaxThreads / 32];
  const int chunks = D / 8;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float xv[V][8], rv[Res ? V : 1][8], gm[V][8];
  bool on[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {  // every load first
    const int c = threadIdx.x + v * blockDim.x;
    on[v] = c < chunks;
    if (on[v]) {
      asq_load8(x + base + 8 * c, xv[v]);
      if constexpr (Res) asq_load8(r + base + 8 * c, rv[v]);
      asq_load8(gamma + 8 * c, gm[v]);
    }
  }
  if constexpr (Res) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!on[v]) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[v][e] = round_to<T>(__fadd_rn(xv[v][e], rv[v][e]));
      asq_store8(s_out + base + 8 * (threadIdx.x + v * blockDim.x), xv[v]);
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

struct Operands {
  const void *x, *r, *gamma;
  void *s, *out;
  int rows, D;
  float eps;
};

template <typename T, typename Out, bool Res>
int launch(const Operands& a, cudaStream_t st) {
  const auto [V, threads] = asq_row_shape(a.D);
  const auto xp = static_cast<const T*>(a.x);
  const auto rp = static_cast<const T*>(a.r);
  const auto gp = static_cast<const float*>(a.gamma);
  const auto sp = static_cast<T*>(a.s);
  const auto op = static_cast<Out*>(a.out);
  if (V == 1) {
    rmsnorm_quant_kernel<T, Out, 1, Res><<<a.rows, threads, 0, st>>>(xp, rp, gp, sp, op, a.D, a.eps);
  } else if (V == 2) {
    rmsnorm_quant_kernel<T, Out, 2, Res><<<a.rows, threads, 0, st>>>(xp, rp, gp, sp, op, a.D, a.eps);
  } else {
    rmsnorm_quant_kernel<T, Out, 3, Res><<<a.rows, threads, 0, st>>>(xp, rp, gp, sp, op, a.D, a.eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Res>
int launch_out(const Operands& a, int out_kind, cudaStream_t st) {
  switch (out_kind) {
    case ASQ_OUT_I8: return launch<T, int8_t, Res>(a, st);
    case ASQ_OUT_F32: return launch<T, float, Res>(a, st);
    case ASQ_OUT_BF16: return launch<T, __nv_bfloat16, Res>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [rows, D] in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); r (the residual)
// null, or [rows, D] in x's dtype, and then s [rows, D] in x's dtype receives
// x + r; gamma [D] f32; out [rows, D] by out_kind (asq_common.cuh's
// AsqOutKind): int8 (ASQ_OUT_I8), f32 or bf16. Needs D % 8 == 0, D <= 12288
// and every operand 16-byte aligned.
ASQ_EXPORT int asq_rmsnorm_quant(const void* x, const void* r, const void* gamma, void* s,
                                 void* out, int rows, int D, float eps, int is_bf16,
                                 int out_kind, void* stream) {
  const bool res = r != nullptr;
  if (res != (s != nullptr) || !asq_row_vec_ok(D, {x, r, gamma, s, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  const Operands a{x, r, gamma, s, out, rows, D, eps};
  if (is_bf16) {
    return res ? launch_out<__nv_bfloat16, true>(a, out_kind, st)
               : launch_out<__nv_bfloat16, false>(a, out_kind, st);
  }
  return res ? launch_out<float, true>(a, out_kind, st) : launch_out<float, false>(a, out_kind, st);
}
