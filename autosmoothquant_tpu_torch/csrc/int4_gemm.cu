// K5: W4A8 GEMM over split-K nibble-packed int4 weights, for M <= 64 rows.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/int4.py:_int4_kernel_a8
// (pallas_call in _int4_matmul_pallas, entry int4_matmul), with the per-token
// scale reduction JAX runs before it and the bias / activation / out-dtype
// epilogue it runs after it:
//
//   tok_scale[m] = max(absmax_k |x[m, k]|, 1e-8) / 127            (f32)
//   x_q[m, k]    = clamp(rint(x[m, k] / tok_scale[m]), -128, 127)  (int8)
//   acc[m, n]    = sum_g scale[n, g] * sum_{k in g} x_q[m, k] * (nib[n, k] - 8)
//   out[m, n]    = act(acc[m, n] * tok_scale[m] + bias[n])
//
// Layout (convert/from_jax.py): packed is [N, K'/2] uint8, byte r of column
// n holding row r in its low nibble and row r + K'/2 in its high nibble, each
// stored as q + 8; scales is [N, G] f32 with G = K' / group. K' >= K is the
// artifact's zero-padded depth; x is [M, K] with its true K, and the
// columns [K, K') count as zero (they quantize to 0 and add nothing), so no
// padded copy of x is made.
//
// What bounds it on an H100: bytes. At decode every packed byte (half the
// int8 weight bytes) and every group scale is read once: K'/2 * N + 4 * G * N
// bytes over 3.35 TB/s.
//
// Design, simple first, two launches:
//  1. quant_rows_kernel, one block per row: the absmax over the row's true K
//     columns, tok_scale with a true f32 division (__fdiv_rn), and x_q over
//     all K' columns (zero past K) into a scratch buffer the wrapper
//     allocates. tok_scale and x_q are bit-exact with the JAX package.
//  2. w4a8_kernel, one warp per output column and up to 8 rows per pass
//     (blockIdx.y walks M in steps of 8): each lane streams 16 packed bytes
//     of the column (coalesced, read once per pass), splits each word into
//     its low and high nibble planes, turns offset binary into signed bytes
//     with __vsub4(nib, 0x08080808), and takes __dp4a against the two
//     matching 16-byte x_q chunks (rows c.. and K'/2 + c..). A 16-row chunk
//     lies inside one group, so its integer partial is exact; it is scaled
//     by the group's scale and summed in f32. A warp shuffle reduces, and
//     asq_store applies tok_scale, bias and the activation. The f32 sum runs
//     in another order than the plain version's sum over groups.
//  Where K'/2 or the group is not a multiple of 16 a byte-wise loop serves.

#include "asq_common.cuh"

namespace {

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, int K, int Kp,
                      int8_t* __restrict__ xq, float* __restrict__ ts) {
  __shared__ float warp_max[kQuantThreads / 32];
  const T* row = x + static_cast<size_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(asq_to_float(row[k])));
  amax = asq_warp_max(amax);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  if (threadIdx.x == 0) ts[blockIdx.x] = scale;
  int8_t* qrow = xq + static_cast<size_t>(blockIdx.x) * Kp;
  for (int k = threadIdx.x; k < Kp; k += kQuantThreads)
    qrow[k] = k < K ? asq_quant_int8(__fdiv_rn(asq_to_float(row[k]), scale)) : 0;
}

constexpr int kRows = 8;
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    w4a8_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ packed,
                const float* __restrict__ scales, int M, int N, int K2, int G,
                int group, bool vec16, AsqEpilogue e) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int Kp = 2 * K2;
  const uint8_t* pr = packed + static_cast<size_t>(n) * K2;
  const float* sr = scales + static_cast<size_t>(n) * G;
  const int8_t* xb = xq + static_cast<size_t>(m0) * Kp;
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  if (vec16) {
    for (int c = lane * 16; c < K2; c += 32 * 16) {
      const uint4 pv = *reinterpret_cast<const uint4*>(pr + c);
      const unsigned words[4] = {pv.x, pv.y, pv.z, pv.w};
      int lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = static_cast<int>(__vsub4(words[i] & 0x0F0F0F0Fu, 0x08080808u));
        hi[i] = static_cast<int>(__vsub4((words[i] >> 4) & 0x0F0F0F0Fu, 0x08080808u));
      }
      const float sl = sr[c / group];
      const float sh = sr[(K2 + c) / group];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < rows) {
          const int8_t* xr = xb + static_cast<size_t>(m) * Kp;
          const int4 xl = *reinterpret_cast<const int4*>(xr + c);
          const int4 xh = *reinterpret_cast<const int4*>(xr + K2 + c);
          int pl = __dp4a(xl.x, lo[0], 0);
          pl = __dp4a(xl.y, lo[1], pl);
          pl = __dp4a(xl.z, lo[2], pl);
          pl = __dp4a(xl.w, lo[3], pl);
          int ph = __dp4a(xh.x, hi[0], 0);
          ph = __dp4a(xh.y, hi[1], ph);
          ph = __dp4a(xh.z, hi[2], ph);
          ph = __dp4a(xh.w, hi[3], ph);
          acc[m] = fmaf(__int2float_rn(pl), sl, acc[m]);
          acc[m] = fmaf(__int2float_rn(ph), sh, acc[m]);
        }
      }
    }
  } else {
    for (int c = lane; c < K2; c += 32) {
      const int b = pr[c];
      const int lo = (b & 15) - 8, hi = (b >> 4) - 8;
      const float sl = sr[c / group];
      const float sh = sr[(K2 + c) / group];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < rows) {
          const int8_t* xr = xb + static_cast<size_t>(m) * Kp;
          acc[m] = fmaf(__int2float_rn(static_cast<int>(xr[c]) * lo), sl, acc[m]);
          acc[m] = fmaf(__int2float_rn(static_cast<int>(xr[K2 + c]) * hi), sh, acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m < rows) {
      const float total = asq_warp_sum(acc[m]);
      if (lane == m) asq_store(e, m0 + m, n, N, total);
    }
  }
}

template <typename T>
int launch_quant(const void* x, int M, int K, int Kp, int8_t* xq, float* ts,
                 cudaStream_t s) {
  quant_rows_kernel<T><<<M, kQuantThreads, 0, s>>>(static_cast<const T*>(x), K,
                                                   Kp, xq, ts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] f32 (x_is_bf16 = 0) or bf16 (1); packed [N, K2] uint8 (K' = 2*K2
// >= K); scales [N, G] f32 (group = K' / G); bias [N] f32 or null; act 0
// none, 1 relu, 2 silu; out [M, N] (out_kind 0: f32, 1: bf16); xq_scratch
// [M, K'] int8 and ts_scratch [M] f32 are written (the quantized x and its
// per-token scales).
ASQ_EXPORT int asq_int4_gemm(const void* x, int x_is_bf16, const void* packed,
                             const void* scales, const void* bias, void* out,
                             void* xq_scratch, void* ts_scratch, int M, int N,
                             int K, int K2, int G, int act, int out_kind,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kp = 2 * K2;
  const int group = Kp / G;
  auto xq = static_cast<int8_t*>(xq_scratch);
  auto ts = static_cast<float*>(ts_scratch);
  const int rc = x_is_bf16 ? launch_quant<__nv_bfloat16>(x, M, K, Kp, xq, ts, s)
                           : launch_quant<float>(x, M, K, Kp, xq, ts, s);
  if (rc != 0) return rc;
  AsqEpilogue e{ts, 1, nullptr, 0, static_cast<const float*>(bias), act,
                out_kind, out};
  const uintptr_t align = reinterpret_cast<uintptr_t>(packed) |
                          reinterpret_cast<uintptr_t>(xq_scratch);
  const bool vec16 = (K2 % 16 == 0) && (group % 16 == 0) && (align % 16 == 0);
  dim3 grid((N + kWarps - 1) / kWarps, (M + kRows - 1) / kRows);
  w4a8_kernel<<<grid, kWarps * 32, 0, s>>>(
      xq, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      M, N, K2, G, group, vec16, e);
  return static_cast<int>(cudaGetLastError());
}
