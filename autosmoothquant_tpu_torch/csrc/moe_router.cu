// The MoE router's logits, one block per (row, group of 8 experts): a
// Mixtral layer's f32 product of its second norm's output with the float
// router weight.
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/mixtral.py:383, jnp.dot(x, router) in f32:
//
//   logits[t, e] = sum_k x[t, k] * w[k, e]      (x f32 [T, D]; w f32 or bf16
//                                               [D, E], widened exactly)
//
// Why the port has it: cuBLAS's f32 product of [T, 4096] x [4096, 8] gives a
// row other bits alone than in a batch (on an H100 a row of rows 1-64 of a
// 128-row product differed from the same row of the whole), so a row's
// routing weights, and the logits downstream, would depend on the batch. The
// continuous engines must give the static b1 engine's logits bit for bit
// (chip_smoke.py's BATCH_LOGIT_NOISE = 0).
//
// Batch invariance: a row's sum order is set by D alone: thread i adds the
// products of columns k = i, i + 256, ... in that order, then the warps'
// shuffle tree, then the 8 warps in order. Every product and sum is an
// explicit round-to-nearest intrinsic (no FMA contraction).
//
// What bounds it on an H100: bytes. A block reads its row (16 KB at D 4096)
// and the router's 8 columns (128 KB in f32) once; a decode step (1-16
// rows) is the launch and one pass over 128 KB, and more rows read the
// weights from L2.

#include "asq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kExperts = 8;  // experts a block

template <typename W>
__global__ void __launch_bounds__(kThreads)
    moe_router_kernel(const float* __restrict__ x, const W* __restrict__ w,
                      float* __restrict__ out, int D, int E) {
  __shared__ float part[kThreads / 32][kExperts];
  const int e0 = blockIdx.y * kExperts;
  const int ne = min(kExperts, E - e0);
  const float* xr = x + static_cast<size_t>(blockIdx.x) * D;
  float acc[kExperts];
#pragma unroll
  for (int j = 0; j < kExperts; ++j) acc[j] = 0.f;
  for (int k = threadIdx.x; k < D; k += kThreads) {
    const float xv = xr[k];
    const W* wr = w + static_cast<size_t>(k) * E + e0;
#pragma unroll
    for (int j = 0; j < kExperts; ++j) {
      if (j < ne) acc[j] = __fadd_rn(acc[j], __fmul_rn(xv, asq_to_float(wr[j])));
    }
  }
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kExperts; ++j) {
    const float v = asq_warp_sum(acc[j]);
    if (threadIdx.x % 32 == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < ne) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total = __fadd_rn(total, part[i][threadIdx.x]);
    out[static_cast<size_t>(blockIdx.x) * E + e0 + threadIdx.x] = total;
  }
}

}  // namespace

// x f32 [rows, D]; w [D, E] in f32 (w_bf16 = 0) or bf16 (w_bf16 = 1); out f32
// [rows, E]. Every operand contiguous.
ASQ_EXPORT int asq_moe_router(const void* x, const void* w, void* out, int rows, int D,
                              int E, int w_bf16, void* stream) {
  if (D <= 0 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, (E + kExperts - 1) / kExperts);
  const auto xp = static_cast<const float*>(x);
  const auto op = static_cast<float*>(out);
  if (w_bf16) {
    moe_router_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xp, static_cast<const __nv_bfloat16*>(w), op, D, E);
  } else {
    moe_router_kernel<float><<<grid, kThreads, 0, s>>>(xp, static_cast<const float*>(w), op,
                                                        D, E);
  }
  return static_cast<int>(cudaGetLastError());
}
