// The MoE routing of a Mixtral layer, whole, in one launch: the router's
// f32 logits, the softmax over the experts, the top k and their
// renormalized weights, from its second norm's output.
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/mixtral.py:383-387, jnp.dot(x, router) in f32,
// jax.nn.softmax, lax.top_k and the renormalization:
//
//   logits[t, e] = sum_k x[t, k] * w[k, e]   (x f32 [T, D]; w f32 or bf16
//                                            [D, E], widened exactly)
//   p[t] = softmax(logits[t])                (f32)
//   top_idx[t] = the k experts of largest p, descending; of equal p the
//                lower expert first (lax.top_k's order, a stable sort's)
//   top_w[t, j] = p[t, top_idx[t, j]] / sum_j' p[t, top_idx[t, j']]
//   combine_rows[t, i], combine_w[t, i] = e T + t and top_w[t, j] of the
//              i-th pick in ascending expert order e (what a combine of
//              the [E, T, N] expert outputs in that order reads)
//
// Why the port has it: cuBLAS's f32 product of [T, 4096] x [4096, 8] gives a
// row other bits alone than in a batch, so a row's routing, and the logits
// downstream, would depend on the batch; and the product alone was one of
// six launches a layer (product, softmax, sort, slice, sum, division).
//
// Batch invariance: a row's logits sum in an order set by D alone: the
// cluster of kNC CTAs splits D into kNC consecutive spans of ceil(D / kNC);
// in CTA c, thread i adds the products of columns k = c * span + i,
// + kThreads, ... in that order, then the warps' xor trees, then the warps
// in order, then CTA 0 adds the kNC CTAs' sums in CTA order (each CTA pushes
// its sums into CTA 0's shared memory). Every product and sum is an explicit
// round-to-nearest intrinsic (no FMA contraction). A cluster takes R rows
// (1 for a decode step of T <= 8, else 8), each summed exactly as alone:
// the grouping reads the router's span once for R rows and changes no sum.
// CTA 0 then gives each row a warp: lane l holds experts l and l + 32, the
// softmax's max and sum are xor trees (the sum of each lane's pair first),
// and the top k are k warp-wide arg-maxes (larger probability, then lower
// expert).
//
// What bounds it on an H100: latency. A decode step's row reads 16 KB of x
// and the router's 128 KB (f32, E 8); one block a row, as before, took
// about 16 dependent round trips to device memory to stream the router.
// The cluster spreads that read over kNC SMs, each thread issuing all of its
// loads (4 columns at D 4096) before its first product, so the row costs one
// round trip, the reductions and one cluster barrier.

#include <cooperative_groups.h>
#include <math_constants.h>

#include "asq_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNC = 8;            // CTAs a cluster (the portable cluster size)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;         // experts a pass over the span
constexpr int kUnroll = 4;        // columns whose loads a thread issues at once
constexpr int kMaxExperts = 64;   // two a lane in the tail
constexpr int kManyRows = 8;      // rows a cluster past a decode step's T

template <typename W, int R>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kThreads)
    moe_route_kernel(const float* __restrict__ x, const W* __restrict__ w, int T, int D, int E,
                     int k, float* __restrict__ logits, float* __restrict__ top_w,
                     int64_t* __restrict__ top_idx, int64_t* __restrict__ combine_rows,
                     float* __restrict__ combine_w) {
  __shared__ float part[kWarps][R][kGroup];
  __shared__ float sums[kNC][R][kMaxExperts];  // CTA 0's: every CTA's, pushed
  __shared__ float pick_p[R][kMaxExperts];
  __shared__ int pick_e[R][kMaxExperts];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / kNC) * R;
  const int nr = min(R, T - row0);
  const int span = (D + kNC - 1) / kNC;
  const int k0 = rank * span, k1 = min(D, k0 + span);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int g0 = 0; g0 < E; g0 += kGroup) {
    const int ne = min(kGroup, E - g0);
    float acc[R][kGroup];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[r][j] = 0.f;
    }
    for (int base = k0 + threadIdx.x; base < k1; base += kUnroll * kThreads) {
      // every load of kUnroll columns first, then the products in column order
      float xv[kUnroll][R], wv[kUnroll][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = base + u * kThreads;
        const bool on = kk < k1;
#pragma unroll
        for (int r = 0; r < R; ++r)
          xv[u][r] = on && r < nr ? x[static_cast<size_t>(row0 + r) * D + kk] : 0.f;
        const W* wr = w + static_cast<size_t>(on ? kk : 0) * E + g0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) wv[u][j] = on && j < ne ? asq_to_float(wr[j]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kThreads < k1) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              acc[r][j] = __fadd_rn(acc[r][j], __fmul_rn(xv[u][r], wv[u][j]));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float v = asq_warp_sum(acc[r][j]);
        if (lane == 0) part[warp][r][j] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * ne; i += kThreads) {
      const int r = i / ne, j = i % ne;
      float total = part[0][r][j];
      for (int q = 1; q < kWarps; ++q) total = __fadd_rn(total, part[q][r][j]);
      *cluster.map_shared_rank(&sums[rank][r][g0 + j], 0) = total;
    }
    __syncthreads();  // part is written again by the next group
  }
  cluster.sync();  // every CTA's sums are in CTA 0; the others are done
  if (rank != 0) return;

  for (int r = warp; r < nr; r += kWarps) {
    const size_t row = static_cast<size_t>(row0 + r);
    const bool on0 = lane < E, on1 = lane + 32 < E;
    float l0 = 0.f, l1 = 0.f;
    if (on0) {
      l0 = sums[0][r][lane];
      for (int c = 1; c < kNC; ++c) l0 = __fadd_rn(l0, sums[c][r][lane]);
    }
    if (on1) {
      l1 = sums[0][r][lane + 32];
      for (int c = 1; c < kNC; ++c) l1 = __fadd_rn(l1, sums[c][r][lane + 32]);
    }
    if (logits != nullptr) {
      if (on0) logits[row * E + lane] = l0;
      if (on1) logits[row * E + lane + 32] = l1;
    }
    if (k == 0) continue;
    // the softmax over the row's E logits
    const float mx = asq_warp_max(fmaxf(on0 ? l0 : -CUDART_INF_F, on1 ? l1 : -CUDART_INF_F));
    const float x0 = on0 ? expf(__fsub_rn(l0, mx)) : 0.f;
    const float x1 = on1 ? expf(__fsub_rn(l1, mx)) : 0.f;
    const float sum = asq_warp_sum(__fadd_rn(x0, x1));
    const float p0 = __fdiv_rn(x0, sum), p1 = __fdiv_rn(x1, sum);
    // the top k: k arg-maxes over the experts not yet taken, the larger
    // probability first, of equal ones the lower expert
    bool taken0 = !on0, taken1 = !on1;
    for (int j = 0; j < k; ++j) {
      float bp = -CUDART_INF_F;
      int be = 0x7fffffff;
      if (!taken0) {
        bp = p0;
        be = lane;
      }
      if (!taken1 && (taken0 || p1 > p0)) {
        bp = p1;
        be = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float op = __shfl_xor_sync(0xffffffffu, bp, o);
        const int oe = __shfl_xor_sync(0xffffffffu, be, o);
        if (op > bp || (op == bp && oe < be)) {
          bp = op;
          be = oe;
        }
      }
      if (lane == 0) {
        pick_p[r][j] = bp;
        pick_e[r][j] = be;
      }
      taken0 = taken0 || be == lane;
      taken1 = taken1 || be == lane + 32;
    }
    __syncwarp();
    float top = 0.f;
    for (int j = 0; j < k; ++j) top = __fadd_rn(top, pick_p[r][j]);
    for (int j = lane; j < k; j += 32) {
      const int e = pick_e[r][j];
      int below = 0;  // this pick's place in ascending expert order
      for (int i = 0; i < k; ++i) below += pick_e[r][i] < e;
      const float wj = __fdiv_rn(pick_p[r][j], top);
      top_w[row * k + j] = wj;
      top_idx[row * k + j] = e;
      combine_rows[row * k + below] = static_cast<int64_t>(e) * T + static_cast<int64_t>(row);
      combine_w[row * k + below] = wj;
    }
  }
}

template <typename W>
void launch_route(const float* x, const W* w, int rows, int D, int E, int k, float* logits,
                  float* top_w, int64_t* top_idx, int64_t* combine_rows, float* combine_w,
                  cudaStream_t s) {
  if (rows <= kManyRows) {
    moe_route_kernel<W, 1><<<rows * kNC, kThreads, 0, s>>>(x, w, rows, D, E, k, logits, top_w,
                                                            top_idx, combine_rows, combine_w);
  } else {
    const int clusters = (rows + kManyRows - 1) / kManyRows;
    moe_route_kernel<W, kManyRows><<<clusters * kNC, kThreads, 0, s>>>(
        x, w, rows, D, E, k, logits, top_w, top_idx, combine_rows, combine_w);
  }
}

}  // namespace

// x f32 [rows, D]; w [D, E] in f32 (w_bf16 = 0) or bf16 (w_bf16 = 1), E <=
// 64; 0 <= k <= E. Writes logits f32 [rows, E] where logits is not null, and,
// for k > 0, top_w f32 [rows, k], top_idx int64 [rows, k], combine_rows
// int64 [rows, k] and combine_w f32 [rows, k]. Every operand contiguous.
ASQ_EXPORT int asq_moe_router(const void* x, const void* w, void* logits, void* top_w,
                              void* top_idx, void* combine_rows, void* combine_w, int rows,
                              int D, int E, int k, int w_bf16, void* stream) {
  if (D <= 0 || E <= 0 || E > kMaxExperts || k < 0 || k > E || rows < 0 ||
      static_cast<long long>(rows) * kNC > 0x7fffffffLL ||
      (k > 0 && (top_w == nullptr || top_idx == nullptr || combine_rows == nullptr ||
                 combine_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto lp = static_cast<float*>(logits);
  const auto wp = static_cast<float*>(top_w);
  const auto ip = static_cast<int64_t*>(top_idx);
  const auto cr = static_cast<int64_t*>(combine_rows);
  const auto cw = static_cast<float*>(combine_w);
  if (w_bf16) {
    launch_route(xp, static_cast<const __nv_bfloat16*>(w), rows, D, E, k, lp, wp, ip, cr, cw, s);
  } else {
    launch_route(xp, static_cast<const float*>(w), rows, D, E, k, lp, wp, ip, cr, cw, s);
  }
  return static_cast<int>(cudaGetLastError());
}
