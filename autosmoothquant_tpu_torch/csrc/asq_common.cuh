// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ASQ_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports the CUDA error text for the codes its entry points
// return (the Python wrapper raises with it).
ASQ_EXPORT const char* asq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float asq_to_float(float x) { return x; }
__device__ __forceinline__ float asq_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T asq_from_float(float x);
template <>
__device__ __forceinline__ float asq_from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 asq_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round half to even, then clamp to int8 (jnp.round / torch.round semantics)
__device__ __forceinline__ int8_t asq_quant_int8(float y) {
  float r = fminf(fmaxf(rintf(y), -128.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float asq_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float asq_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int asq_warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The GEMM epilogue the int8, fp8 and int4 kernels share:
//   out[m, n] = act(acc * row_scale[m] * col_scale[n] + bias[n])
// multiplied in the JAX order (acc * row) * col, then the bias added, with
// explicit round-to-nearest intrinsics so nvcc cannot contract them into an
// FMA: given the same acc, the output has the plain PyTorch version's bits.
enum AsqOutKind { ASQ_OUT_F32 = 0, ASQ_OUT_BF16 = 1, ASQ_OUT_I8 = 2 };
enum AsqAct { ASQ_ACT_NONE = 0, ASQ_ACT_RELU = 1, ASQ_ACT_SILU = 2 };

struct AsqEpilogue {
  const float* rs;  // row scale; rs_stride 0 broadcasts one value; null: 1
  int rs_stride;
  const float* cs;  // column scale; cs_stride 0 broadcasts one value; null: 1
  int cs_stride;
  const float* bias;  // [N] or nullptr
  int act;
  int out_kind;
  void* out;  // [M, N]
};

__device__ __forceinline__ void asq_store(const AsqEpilogue& e, int m, int n,
                                          int N, float acc) {
  const float rs = e.rs != nullptr ? e.rs[m * e.rs_stride] : 1.f;
  const float cs = e.cs != nullptr ? e.cs[n * e.cs_stride] : 1.f;
  float v = __fmul_rn(__fmul_rn(acc, rs), cs);
  if (e.bias != nullptr) v = __fadd_rn(v, e.bias[n]);
  if (e.act == ASQ_ACT_RELU) {
    v = fmaxf(v, 0.f);
  } else if (e.act == ASQ_ACT_SILU) {
    v = __fmul_rn(v, 1.f / (1.f + expf(-v)));
  }
  const size_t idx = static_cast<size_t>(m) * N + n;
  if (e.out_kind == ASQ_OUT_F32) {
    static_cast<float*>(e.out)[idx] = v;
  } else if (e.out_kind == ASQ_OUT_BF16) {
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<int8_t*>(e.out)[idx] = asq_quant_int8(v);
  }
}
