// K4: fp8 x fp8 GEMM (e4m3fn or e5m2) with f32 accumulation and the scale
// epilogue fused in.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/fp8.py:_fp8_kernel
// (pallas_call in _fp8_matmul_pallas, entry fp8_stream_matmul) together with
// the scale epilogue kernels/gemm.py:fp8_matmul applies after it:
//
//   out[m, n] = (acc[m, n] * row_scale[m]) * col_scale[n] + bias[n]
//   acc       = sum_k true(x[m, k]) * true(w_t[n, k])          (f32)
//
// with out in f32 or bf16. x is [M, K] and w_t is [N, K], both K-contiguous;
// the JAX package's [K, N] weights are transposed once at load time. The
// format (e4m3fn or e5m2) is one template parameter.
//
// The TPU kernel exists because v5e has no fp8 unit: it rebuilds bf16 from
// the bytes with integer tricks, only for M <= 64 and behind a flag. On
// Hopper the conversion is native (cuda_fp8.h), so this kernel is the fp8
// path for every M.
//
// What bounds it on an H100: at decode (M = 1..8) every weight byte is read
// once and used M times, so the time is the N*K weight bytes over 3.35 TB/s.
// At prefill it is compute: 2*M*N*K operations (1,979 TFLOP/s fp8 peak on the
// tensor cores; this first kernel runs on CUDA cores).
//
// Design, simple first:
//  - M <= 8: one warp per output column. Each lane streams 16-byte chunks of
//    the weight row (coalesced, read once) and the matching x chunks (cached),
//    converts pairs with __nv_cvt_fp8x2_to_halfraw2 (exact: every e4m3 and
//    e5m2 value, subnormals included, is a half) and accumulates with fmaf. A
//    product of two fp8 values is exact in f32, so only the summation order
//    differs from the plain version; a warp shuffle reduces.
//  - M > 8: 64x64 output tiles, 32-deep K steps converted to f32 into shared
//    memory, 256 threads each holding a 4x4 block of f32 accumulators.
//    Tensor cores (mma.sync .e4m3 / wgmma) are a later change.
//  - Ragged M, N and K edges are masked in the kernel (zero bytes are +0).
//  - The epilogue is asq_store (asq_common.cuh).

#include <cuda_fp8.h>

#include "asq_common.cuh"

namespace {

template <__nv_fp8_interpretation_t F>
__device__ __forceinline__ float fp8_to_float(uint8_t v) {
  const __half_raw r = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v), F);
  return __half2float(__half(r));
}

// Four fp8 values packed in a word (byte 0 first) as f32.
template <__nv_fp8_interpretation_t F>
__device__ __forceinline__ void fp8x4_to_float(unsigned w, float* f) {
  const __half2_raw a = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), F);
  const __half2_raw b = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), F);
  const float2 fa = __half22float2(__half2(a));
  const float2 fb = __half22float2(__half2(b));
  f[0] = fa.x;
  f[1] = fa.y;
  f[2] = fb.x;
  f[3] = fb.y;
}

template <__nv_fp8_interpretation_t F>
__device__ __forceinline__ void fp8x16_to_float(const uint4& v, float* f) {
  fp8x4_to_float<F>(v.x, f);
  fp8x4_to_float<F>(v.y, f + 4);
  fp8x4_to_float<F>(v.z, f + 8);
  fp8x4_to_float<F>(v.w, f + 12);
}

constexpr int kGemvMaxM = 8;
constexpr int kGemvWarps = 8;

// One warp per output column n; all M (<= 8) rows at once.
template <__nv_fp8_interpretation_t F>
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                int M, int N, int K, bool vec16, AsqEpilogue e) {
  const int n = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const uint8_t* wr = w + static_cast<size_t>(n) * K;
  float acc[kGemvMaxM];
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) acc[m] = 0.f;
  if (vec16) {
    for (int k = lane * 16; k < K; k += 32 * 16) {
      float wf[16];
      fp8x16_to_float<F>(*reinterpret_cast<const uint4*>(wr + k), wf);
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m) {
        if (m < M) {
          float xf[16];
          fp8x16_to_float<F>(*reinterpret_cast<const uint4*>(
                                 x + static_cast<size_t>(m) * K + k), xf);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], wf[i], a);
          acc[m] = a;
        }
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float wv = fp8_to_float<F>(wr[k]);
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m)
        if (m < M)
          acc[m] = fmaf(fp8_to_float<F>(x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) {
    if (m < M) {
      const float total = asq_warp_sum(acc[m]);
      if (lane == m) asq_store(e, m, n, N, total);
    }
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 32;

// Four consecutive fp8 of row `row` starting at k as f32; zero outside
// [0, rows) x [0, K).
template <__nv_fp8_interpretation_t F>
__device__ __forceinline__ void load4(const uint8_t* __restrict__ p, int row,
                                      int rows, int k, int K, bool al4, float* f) {
  unsigned v = 0;
  if (row < rows && k < K) {
    const uint8_t* r = p + static_cast<size_t>(row) * K;
    if (al4) {
      v = *reinterpret_cast<const unsigned*>(r + k);  // K % 4 == 0
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + b < K) v |= static_cast<unsigned>(r[k + b]) << (8 * b);
    }
  }
  fp8x4_to_float<F>(v, f);
}

template <__nv_fp8_interpretation_t F>
__global__ void __launch_bounds__(256)
    gemm_tiled_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                      int M, int N, int K, bool al4, AsqEpilogue e) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 64 rows x 8 words of 4 fp8 values per operand: two words a thread
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 4); i += 256) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      float f[4];
      load4<F>(x, m0 + r, M, k0 + c, K, al4, f);
#pragma unroll
      for (int q = 0; q < 4; ++q) As[c + q][r] = f[q];
      load4<F>(w, n0 + r, N, k0 + c, K, al4, f);
#pragma unroll
      for (int q = 0; q < 4; ++q) Bs[c + q][r] = f[q];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) asq_store(e, m, n, N, acc[i][j]);
    }
  }
}

template <__nv_fp8_interpretation_t F>
void launch(const uint8_t* x, const uint8_t* w, int M, int N, int K,
            uintptr_t align, const AsqEpilogue& e, cudaStream_t s) {
  if (M <= kGemvMaxM) {
    const bool vec16 = (K % 16 == 0) && (align % 16 == 0);
    const int blocks = (N + kGemvWarps - 1) / kGemvWarps;
    gemv_kernel<F><<<blocks, kGemvWarps * 32, 0, s>>>(x, w, M, N, K, vec16, e);
  } else {
    const bool al4 = (K % 4 == 0) && (align % 4 == 0);
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_tiled_kernel<F><<<grid, 256, 0, s>>>(x, w, M, N, K, al4, e);
  }
}

}  // namespace

// x [M, K] fp8, w_t [N, K] fp8 (fmt 0: e4m3fn, 1: e5m2), row_scale
// (rs_stride 0: one value, 1: [M]; null: 1), col_scale (cs_stride 0: one
// value, 1: [N]; null: 1), bias [N] f32 or null, out [M, N] (out_kind 0: f32,
// 1: bf16).
ASQ_EXPORT int asq_fp8_gemm(const void* x, const void* w_t, const void* row_scale,
                            int rs_stride, const void* col_scale, int cs_stride,
                            const void* bias, void* out, int M, int N, int K,
                            int fmt, int out_kind, void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride,
                static_cast<const float*>(bias), ASQ_ACT_NONE, out_kind, out};
  const auto xp = static_cast<const uint8_t*>(x);
  const auto wp = static_cast<const uint8_t*>(w_t);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 0) {
    launch<__NV_E4M3>(xp, wp, M, N, K, align, e, s);
  } else {
    launch<__NV_E5M2>(xp, wp, M, N, K, align, e, s);
  }
  return static_cast<int>(cudaGetLastError());
}
