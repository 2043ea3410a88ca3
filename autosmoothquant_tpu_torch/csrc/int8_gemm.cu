// K1: int8 x int8 -> int32 GEMM with the dequantizing epilogue fused in.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/gemm.py:
// _int8_matmul_kernel (pallas_call in _int8_matmul_pallas, entry int8_matmul):
//
//   out[m, n] = act(acc[m, n] * row_scale[m] * col_scale[n] + bias[n])
//   acc       = sum_k x[m, k] * w_t[n, k]          (exact, int32)
//
// with out in f32, bf16 or int8 (round half to even, clamp to [-128, 127]).
// x is [M, K] and w_t is [N, K], both K-contiguous (nn.Linear's layout); the
// JAX package's [K, N] weights are transposed once at load time.
//
// What bounds it on an H100: at decode (M = batch, 1..8) every weight byte is
// read once and used M times, so the time is the weight bytes over 3.35 TB/s.
// At prefill (M = B*T) it is compute: 2*M*N*K int8 operations.
//
// Design, simple first:
//  - M <= 8: one warp per output column. Each lane streams 16-byte chunks of
//    the weight row (coalesced, read once) and the matching x chunks (a few
//    KB, cached) and accumulates with __dp4a; a warp shuffle reduces.
//  - M > 8: 64x64 output tiles, 64-byte K steps staged in shared memory,
//    256 threads each holding a 4x4 block of int32 accumulators (__dp4a).
//    Tensor cores (mma.sync / wgmma) are a later change.
//  - Ragged M, N and K edges are masked in the kernel (zero-filled words), so
//    no shape or alignment is refused; the 16-byte and 4-byte load paths are
//    taken only where K and the pointers allow them.
//  - The epilogue (asq_store, asq_common.cuh) multiplies in the JAX order
//    (acc * row) * col, then adds the bias, with explicit round-to-nearest
//    intrinsics: the f32 output equals the plain PyTorch version's bits.

#include "asq_common.cuh"

namespace {

constexpr int kGemvMaxM = 8;
constexpr int kGemvWarps = 8;

// One warp per output column n; all M (<= 8) rows at once.
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int M, int N, int K, bool vec16, AsqEpilogue e) {
  const int n = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const int8_t* wr = w + static_cast<size_t>(n) * K;
  int acc[kGemvMaxM];
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) acc[m] = 0;
  if (vec16) {
#pragma unroll 4
    for (int k = lane * 16; k < K; k += 32 * 16) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + k);
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m) {
        if (m < M) {
          const int4 xv = *reinterpret_cast<const int4*>(
              x + static_cast<size_t>(m) * K + k);
          int a = acc[m];
          a = __dp4a(xv.x, wv.x, a);
          a = __dp4a(xv.y, wv.y, a);
          a = __dp4a(xv.z, wv.z, a);
          a = __dp4a(xv.w, wv.w, a);
          acc[m] = a;
        }
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const int wv = wr[k];
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m)
        if (m < M) acc[m] += static_cast<int>(x[static_cast<size_t>(m) * K + k]) * wv;
    }
  }
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) {
    if (m < M) {
      const int total = asq_warp_sum_int(acc[m]);
      if (lane == m) asq_store(e, m, n, N, __int2float_rn(total));
    }
  }
}

constexpr int kBM = 64, kBN = 64, kBKW = 16;  // K step: 16 words = 64 bytes

// Four consecutive int8 of row `row` starting at k, packed little-endian;
// zero outside [0, rows) x [0, K).
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p, int row,
                                         int rows, int k, int K, bool al4) {
  if (row >= rows || k >= K) return 0;
  const int8_t* r = p + static_cast<size_t>(row) * K;
  if (al4) return *reinterpret_cast<const int*>(r + k);  // K % 4 == 0
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kk = k + b;
    const int byte = kk < K ? static_cast<int>(static_cast<uint8_t>(r[kk])) : 0;
    v |= byte << (8 * b);
  }
  return v;
}

__global__ void __launch_bounds__(256)
    gemm_tiled_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      int M, int N, int K, bool al4, AsqEpilogue e) {
  __shared__ int As[kBM][kBKW + 1];
  __shared__ int Bs[kBN][kBKW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBKW * 4) {
#pragma unroll
    for (int i = tid; i < kBM * kBKW; i += 256) {
      const int r = i / kBKW, c = i % kBKW;
      As[r][c] = load_word(x, m0 + r, M, k0 + c * 4, K, al4);
      Bs[r][c] = load_word(w, n0 + r, N, k0 + c * 4, K, al4);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kBKW; ++c) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) asq_store(e, m, n, N, __int2float_rn(acc[i][j]));
    }
  }
}

}  // namespace

// x [M, K] int8, w_t [N, K] int8, row_scale (rs_stride 0: one value, 1: [M];
// null: 1), col_scale (cs_stride 0: one value, 1: [N]; null: 1), bias [N] f32
// or null, out [M, N].
// act: 0 none, 1 relu, 2 silu; out_kind: 0 f32, 1 bf16, 2 int8.
ASQ_EXPORT int asq_int8_gemm(const void* x, const void* w_t, const void* row_scale,
                             int rs_stride, const void* col_scale, int cs_stride,
                             const void* bias, void* out, int M, int N, int K,
                             int act, int out_kind, void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
             static_cast<const float*>(col_scale), cs_stride,
             static_cast<const float*>(bias), act, out_kind, out};
  const auto xp = static_cast<const int8_t*>(x);
  const auto wp = static_cast<const int8_t*>(w_t);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kGemvMaxM) {
    const bool vec16 = (K % 16 == 0) && (align % 16 == 0);
    const int blocks = (N + kGemvWarps - 1) / kGemvWarps;
    gemv_kernel<<<blocks, kGemvWarps * 32, 0, s>>>(xp, wp, M, N, K, vec16, e);
  } else {
    const bool al4 = (K % 4 == 0) && (align % 4 == 0);
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_tiled_kernel<<<grid, 256, 0, s>>>(xp, wp, M, N, K, al4, e);
  }
  return static_cast<int>(cudaGetLastError());
}
