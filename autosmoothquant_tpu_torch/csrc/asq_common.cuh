// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// LayerNorm's inverse root: 1 / sqrt(v) in f64 (both IEEE, correctly
// rounded), rounded once to f32: the plain version's quant/math.py:rsqrt_rn,
// so the card and the CPU take the same bits (1.f / sqrtf, two f32
// roundings and RMSNorm's root, parts from it in about one value in four)
__device__ __forceinline__ float asq_rsqrt_rn(float v) {
  return __double2float_rn(1.0 / sqrt(static_cast<double>(v)));
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

// ---------------------------------------------------------------------------
// A row held in registers, 8 elements a chunk (K2's and K6's vector routes)
// ---------------------------------------------------------------------------

// A thread owns V chunks of 8 (V = 1..kAsqRowMaxV, a template argument of
// the kernel) and a block up to kAsqRowMaxThreads threads: rows of D % 8 == 0
// elements up to kAsqRowMaxD.
constexpr int kAsqRowMaxThreads = 512;
constexpr int kAsqRowMaxV = 3;
constexpr int kAsqRowMaxD = 8 * kAsqRowMaxV * kAsqRowMaxThreads;  // 12288

struct AsqRowShape {
  int V, threads;  // chunks a thread; threads a block (a multiple of 32)
};

inline AsqRowShape asq_row_shape(int D) {
  const int chunks = D / 8;
  const int V = (chunks + kAsqRowMaxThreads - 1) / kAsqRowMaxThreads;
  return {V, ((chunks + V - 1) / V + 31) / 32 * 32};
}

// Whether a vector route takes rows of D elements at these addresses
// (every one 16-byte aligned).
inline bool asq_row_vec_ok(int D, std::initializer_list<const void*> ptrs) {
  uintptr_t align = 0;
  for (const void* p : ptrs) align |= reinterpret_cast<uintptr_t>(p);
  return D % 8 == 0 && D <= kAsqRowMaxD && align % 16 == 0;
}

// 8 elements from a 16-byte aligned address: two float4s (f32) or one
// 16-byte vector (bf16), widened to f32.
__device__ __forceinline__ void asq_load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void asq_load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 elements to a 16-byte aligned address, rounded to nearest for bf16.
__device__ __forceinline__ void asq_store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void asq_store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The int8 of 8 values (round half to even, clamped) as one 8-byte store to
// an 8-byte aligned address.
__device__ __forceinline__ void asq_store8_int8(int8_t* p, const float (&y)[8]) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(asq_quant_int8(y[e]))) << (8 * (e % 4));
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The block's sum of v (blockDim.x a multiple of 32), returned to every
// thread, in a fixed order: a warp shuffle, then one exchange through
// shared memory (one barrier). Each call needs its own `part` (blockDim.x /
// 32 floats), since no barrier follows the reads.
__device__ __forceinline__ float asq_block_sum(float v, float* part) {
  v = asq_warp_sum(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) total = __fadd_rn(total, part[w]);
  return total;
}

// The GEMM epilogue the int8, fp8 and int4 kernels share:
//   out[m, n] = act(acc * row_scale[m] * col_scale[n] + bias[n])
// multiplied in the JAX order (acc * row) * col, then the bias added, with
// explicit round-to-nearest intrinsics so nvcc cannot contract them into an
// FMA: given the same acc, the output has the plain PyTorch version's bits.
// ASQ_OUT_I32 (K1 only) writes the int32 accumulator itself: no scale, bias
// or activation (the row-parallel partial that an all-reduce over ranks sums
// before the epilogue runs once, models/common.py:row_parallel).
enum AsqOutKind { ASQ_OUT_F32 = 0, ASQ_OUT_BF16 = 1, ASQ_OUT_I8 = 2, ASQ_OUT_I32 = 3 };
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

// The operands asq_store reads for output (m, n): row scale, column scale
// and bias (1, 1 and 0 where absent). A kernel may load them before its main
// loop, so their device-memory round trip does not follow the last product.
struct AsqOperands {
  float rs, cs, bias;
};

__device__ __forceinline__ AsqOperands asq_operands(const AsqEpilogue& e, int m, int n) {
  return {e.rs != nullptr ? e.rs[m * e.rs_stride] : 1.f,
          e.cs != nullptr ? e.cs[n * e.cs_stride] : 1.f, e.bias != nullptr ? e.bias[n] : 0.f};
}

__device__ __forceinline__ void asq_store(const AsqEpilogue& e, const AsqOperands& o, int m,
                                          int n, int N, float acc) {
  float v = __fmul_rn(__fmul_rn(acc, o.rs), o.cs);
  if (e.bias != nullptr) v = __fadd_rn(v, o.bias);
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

__device__ __forceinline__ void asq_store(const AsqEpilogue& e, int m, int n, int N,
                                          float acc) {
  asq_store(e, asq_operands(e, m, n), m, n, N, acc);
}

// An exact int32 accumulator (K1's routes): written as it is for
// ASQ_OUT_I32, else the epilogue of its f32 value.
__device__ __forceinline__ void asq_store(const AsqEpilogue& e, const AsqOperands& o, int m,
                                          int n, int N, int acc) {
  if (e.out_kind == ASQ_OUT_I32) {
    static_cast<int*>(e.out)[static_cast<size_t>(m) * N + n] = acc;
    return;
  }
  asq_store(e, o, m, n, N, __int2float_rn(acc));
}

__device__ __forceinline__ void asq_store(const AsqEpilogue& e, int m, int n, int N, int acc) {
  asq_store(e, asq_operands(e, m, n), m, n, N, acc);
}
