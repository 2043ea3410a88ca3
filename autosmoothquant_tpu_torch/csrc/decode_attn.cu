// Decode attention: one query token a row against its KV cache, one kernel a
// layer, over a contiguous cache or block-paged pages.
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/common.py:1255 attend at T = 1 (the decode step
// of the static and continuous engines) and :571 paged_attend at T = 1 (the
// paged engine's decode step):
//
//   s_j = (q . k_j) * scale [* k_scale_j]           (f32; int8 cache)
//   s_j = -1e30 unless j <= pos, j > pos - window (a sliding window) and
//         kv_valid[j] (where given)
//   p_j = exp(s_j - max s) / sum exp(s - max s) [* v_scale_j]
//         [rounded to bf16 on the bf16 path]
//   out = sum_j p_j v_j                              (f32, stored in q's dtype)
//
// with Hq / Hkv query heads sharing each kv head (GQA). An int8 cache is
// read raw: its per-token-per-head scales factor out of both products, as
// the eager attend factors them.
//
// Layout: q and out [B, Hq, D]. Contiguous: k, v [B, S, Hkv, D] (scales [B,
// S, Hkv]), key j of row b at (b * S + j). Paged: k, v [N, bs, Hkv, D]
// pages (scales [N, bs, Hkv]), key j of row b in page table[b, j / bs] at
// offset j % bs; the block index is clamped to the table's last column, so
// no key reads past the table.
//
// Design: one block of 512 threads a (row, kv head), its G = Hq / Hkv query
// heads together, in three passes over a score row of G x n_cols f32 kept
// in shared memory, or, where that would not fit (long contexts: past about
// 5.9K columns at G = 8), in a global workspace the caller passes, block
// (b, h) at offset (b * Hkv + h) x G x n_cols. Either place holds the same
// f32 values, so the output's bits do not depend on which one a launch
// uses:
//  1. scores: thread t takes keys j = t, t + 512, ...; it reads key j with
//     16-byte loads (four issued at once) and dots it with each head's q
//     (in shared memory) in order of d (fmaf), so one key row is read once
//     for all G heads;
//  2. softmax: each head's max, then its sum of exp(s - max), a thread's
//     keys in order, then the warp's xor tree, then the warps in order;
//  3. values: a thread owns two adjacent d of one of KG key groups (key j in
//     group j % KG), loads the values of 8 of its keys at once and sums p_j
//     v_j over its keys in order for each head, and the KG partial sums are
//     added in group order.
// Keys past the row's position (and before its window) are skipped: their
// probability is exactly 0, so skipping them changes no bit.
//
// Batch invariance: every sum above runs in an order set by key position
// and D alone. A row's output is the same in any batch and whether the
// scan is bounded by kv_window or by S.
//
// What bounds it on an H100: bytes. It reads each valid key and value once
// (TinyLlama b8 at kv_window 256: 2 x 8 x 256 x 4 x 64 x 2 B = 1.05 MB a
// layer, 0.3 us at 3.35 TB/s); at decode sizes the time is the launch and a
// few round trips to device memory.

#include "asq_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kHeadGroup = 8;  // query heads a pass keeps in registers
constexpr int kUnroll = 8;     // keys whose values a thread loads at once
constexpr float kMasked = -1e30f;

enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // null: contiguous
  const long long* pos;
  const unsigned char* kv_valid;  // null: none
  void* out;
  float* scores;  // null: the score row in shared memory
  int Hq, Hkv, D;
  int kv_rows;     // contiguous: S; paged: the page size bs
  int table_cols;  // paged: the table's columns
  int pos_stride, valid_stride;
  int n_cols;  // the columns scanned (kv_window)
  int window;  // sliding window; 0: none
  float scale;
  int round_p;  // round the probabilities to bf16 before the value product
};

// 8 consecutive elements of a cache row, widened to f32.
template <int K>
__device__ __forceinline__ void load8(const void* base, size_t idx, float (&x)[8]) {
  if constexpr (K == KV_F32) {
    asq_load8(static_cast<const float*>(base) + idx, x);
  } else if constexpr (K == KV_BF16) {
    asq_load8(static_cast<const __nv_bfloat16*>(base) + idx, x);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + idx);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xff));
  }
}

// 2 consecutive elements of a cache row, widened to f32.
template <int K>
__device__ __forceinline__ float2 load2(const void* base, size_t idx) {
  if constexpr (K == KV_F32) {
    return *reinterpret_cast<const float2*>(static_cast<const float*>(base) + idx);
  } else if constexpr (K == KV_BF16) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(base) + idx));
  } else {
    const char2 c = *reinterpret_cast<const char2*>(static_cast<const int8_t*>(base) + idx);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
}

// The block's reduction of one value a thread for each of n heads (n <=
// kHeadGroup), returned to every thread: a warp's xor tree, then the warps'
// results in warp order (sum) or their max. `part` holds kHeadGroup x kWarps
// floats.
constexpr int kWarps = kThreads / 32;

template <bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kHeadGroup], int n, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int g = 0; g < kHeadGroup; ++g) {
    if (g >= n) break;
    v[g] = kMax ? asq_warp_max(v[g]) : asq_warp_sum(v[g]);
    if (lane == 0) part[g * kWarps + warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kHeadGroup; ++g) {
    if (g >= n) break;
    float w[kWarps];  // every load first, then the sum in warp order
#pragma unroll
    for (int i = 0; i < kWarps; ++i) w[i] = part[g * kWarps + i];
    float t = w[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) t = kMax ? fmaxf(t, w[i]) : __fadd_rn(t, w[i]);
    v[g] = t;
  }
  __syncthreads();  // part is reused by the next reduction
}

template <typename Tq, int K>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float part[kHeadGroup * kWarps];
  __shared__ float stats[2 * 64];  // each head's max and sum (G <= 64)
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int G = a.Hq / a.Hkv, D = a.D, tid = threadIdx.x;
  const int np = D <= 64 ? 32 : 64, kg_count = kThreads / np;
  float* q_s = smem;  // [G][D]
  // [G][n_cols]
  float* s_s = a.scores != nullptr
                   ? a.scores + static_cast<size_t>(blockIdx.x) * G * a.n_cols
                   : q_s + G * D;
  float* o_s = a.scores != nullptr ? q_s + G * D : s_s + G * a.n_cols;  // [kg_count][G][D]

  // the cache slot (token index into [.., Hkv, D] rows) of key j of this row
  // (the kernel's parameters are copied out first: taking their address
  // would move them to local memory)
  const int* table = a.table == nullptr ? nullptr : a.table + static_cast<size_t>(b) * a.table_cols;
  const int kv_rows = a.kv_rows, last_col = a.table_cols - 1;
  auto slot_of = [=](int j) -> size_t {
    if (table == nullptr) return static_cast<size_t>(b) * kv_rows + j;
    return static_cast<size_t>(table[min(j / kv_rows, last_col)]) * kv_rows + j % kv_rows;
  };
  const long long p = a.pos[static_cast<size_t>(b) * a.pos_stride];
  const int n = static_cast<int>(min(static_cast<long long>(a.n_cols), p + 1));
  const int j0 = a.window > 0 ? static_cast<int>(max(0LL, p - a.window + 1)) : 0;
  const Tq* q = static_cast<const Tq*>(a.q) + (static_cast<size_t>(b) * a.Hq + h * G) * D;
  Tq* out = static_cast<Tq*>(a.out) + (static_cast<size_t>(b) * a.Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = asq_to_float(q[i]);
  __syncthreads();

  // 1. scores
  const size_t kv_head = static_cast<size_t>(h) * D;
  for (int j = tid; j < n; j += kThreads) {
    if (j < j0) continue;
    const size_t slot = slot_of(j);
    const bool ok = a.kv_valid == nullptr || a.kv_valid[static_cast<size_t>(b) * a.valid_stride + j];
    const float ks = (K == KV_INT8 && ok) ? a.k_scale[slot * a.Hkv + h] : 1.f;
    const size_t row = slot * a.Hkv * D + kv_head;
    for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
      float acc[kHeadGroup];
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g) acc[g] = 0.f;
      if (ok) {
        // 32 elements of the key a step, their loads issued together
        for (int d0 = 0; d0 < D; d0 += 32) {
          float kf[4][8];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (d0 + 8 * c < D) load8<K>(a.k, row + d0 + 8 * c, kf[c]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (d0 + 8 * c >= D) break;
#pragma unroll
            for (int g = 0; g < kHeadGroup; ++g) {
              if (g0 + g >= G) break;
              const float* qg = q_s + (g0 + g) * D + d0 + 8 * c;
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[g] = fmaf(qg[e], kf[c][e], acc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g) {
        if (g0 + g >= G) break;
        float s = __fmul_rn(acc[g], a.scale);
        if (K == KV_INT8) s = __fmul_rn(s, ks);
        s_s[(g0 + g) * a.n_cols + j] = ok ? s : kMasked;
      }
    }
  }
  __syncthreads();

  // 2. softmax statistics, then the probabilities in place
  for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
    const int ng = min(kHeadGroup, G - g0);
    float m[kHeadGroup], l[kHeadGroup];
#pragma unroll
    for (int g = 0; g < kHeadGroup; ++g) m[g] = kMasked;
    for (int j = tid; j < n; j += kThreads) {
      if (j < j0) continue;
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g)
        if (g < ng) m[g] = fmaxf(m[g], s_s[(g0 + g) * a.n_cols + j]);
    }
    block_reduce<true>(m, ng, part);
#pragma unroll
    for (int g = 0; g < kHeadGroup; ++g) l[g] = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      if (j < j0) continue;
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g)
        if (g < ng) l[g] = __fadd_rn(l[g], expf(s_s[(g0 + g) * a.n_cols + j] - m[g]));
    }
    block_reduce<false>(l, ng, part);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g) {
        if (g >= ng) break;
        stats[g0 + g] = m[g];
        stats[64 + g0 + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    if (j < j0) continue;
    const float vs = K == KV_INT8 ? a.v_scale[slot_of(j) * a.Hkv + h] : 1.f;
    for (int g = 0; g < G; ++g) {
      float* sp = s_s + g * a.n_cols + j;
      float pr = expf(*sp - stats[g]) / stats[64 + g];
      if (K == KV_INT8) pr = __fmul_rn(pr, vs);
      if (a.round_p) pr = __bfloat162float(__float2bfloat16_rn(pr));
      *sp = pr;
    }
  }
  __syncthreads();

  // 3. values: thread (pair pi, key group kg)
  const int pi = tid % np, kg = tid / np;
  const bool active = 2 * pi < D;
  for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
    float acc[kHeadGroup][2];
#pragma unroll
    for (int g = 0; g < kHeadGroup; ++g) acc[g][0] = acc[g][1] = 0.f;
    if (active) {
      // the first key of this group at or after j0
      const int first = j0 + ((kg - j0 % kg_count) + kg_count) % kg_count;
      // kUnroll of the group's keys a step, their loads issued together, then
      // added in key order
      for (int j = first; j < n; j += kUnroll * kg_count) {
        float2 vv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ju = j + u * kg_count;
          if (ju < n) vv[u] = load2<K>(a.v, slot_of(ju) * a.Hkv * D + kv_head + 2 * pi);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ju = j + u * kg_count;
          if (ju >= n) break;
#pragma unroll
          for (int g = 0; g < kHeadGroup; ++g) {
            if (g0 + g >= G) break;
            const float pr = s_s[(g0 + g) * a.n_cols + ju];
            acc[g][0] = fmaf(pr, vv[u].x, acc[g][0]);
            acc[g][1] = fmaf(pr, vv[u].y, acc[g][1]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kHeadGroup; ++g) {
        if (g0 + g >= G) break;
        float* o = o_s + (static_cast<size_t>(kg) * G + g0 + g) * D + 2 * pi;
        o[0] = acc[g][0];
        o[1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float t = o_s[i];
    for (int c = 1; c < kg_count; ++c) t = __fadd_rn(t, o_s[static_cast<size_t>(c) * G * D + i]);
    // a row with no valid key (every score masked) is written as 0
    if (n <= j0 || stats[i / D] <= kMasked) t = 0.f;
    out[i] = asq_from_float<Tq>(t);
  }
}

// the dynamic shared memory of a launch; scores_in_smem: the score row's too
size_t smem_bytes(int G, int D, int n_cols, bool scores_in_smem) {
  const int kg_count = kThreads / (D <= 64 ? 32 : 64);
  return sizeof(float) *
         (static_cast<size_t>(G) * D + (scores_in_smem ? static_cast<size_t>(G) * n_cols : 0) +
          static_cast<size_t>(kg_count) * G * D);
}

template <typename Tq, int K>
int launch(const Args& a, int B, cudaStream_t s) {
  // grant the kernel all the dynamic shared memory a block may have beside
  // its static arrays, once, at the first launch (an eager step, never
  // inside a graph capture): occupancy follows each launch's own size
  static int granted = -1;
  if (granted < 0) {
    cudaFuncAttributes attr;
    int device = 0, optin = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, decode_attn_kernel<Tq, K>);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const int most = optin - static_cast<int>(attr.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_attn_kernel<Tq, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = most;
  }
  const size_t smem = smem_bytes(a.Hq / a.Hkv, a.D, a.n_cols, a.scores == nullptr);
  if (smem > static_cast<size_t>(granted)) return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_kernel<Tq, K><<<B * a.Hkv, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tq>
int launch_kv(const Args& a, int B, int kv_kind, cudaStream_t s) {
  if (kv_kind == KV_F32) return launch<Tq, KV_F32>(a, B, s);
  if (kv_kind == KV_BF16) return launch<Tq, KV_BF16>(a, B, s);
  return launch<Tq, KV_INT8>(a, B, s);
}

}  // namespace

// q, out [B, Hq, D] (q_bf16: bf16, else f32); k, v and k_scale, v_scale
// (f32, int8 caches only, else null) as the note above lays them out;
// table int32 [B, table_cols] (paged) or null (contiguous); pos int64, row
// b's at pos[b * pos_stride]; kv_valid bool [B, valid_stride] or null;
// scores: an f32 workspace of B x Hq x n_cols for the score rows, or null to
// keep them in shared memory. kv_kind: 0 f32, 1 bf16, 2 int8. Needs D % 8 ==
// 0, D <= 128, Hq % Hkv == 0, Hq / Hkv <= 64, 16-byte aligned q, k and v,
// and 4 x (G x D [+ G x n_cols without a workspace] + KG x G x D) bytes of
// shared memory (G = Hq / Hkv; KG = 16 key groups for D <= 64, else 8)
// within what a block may have beside its static arrays (about 226 KB on
// an H100).
ASQ_EXPORT int asq_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* table, const void* pos, const void* kv_valid,
                                    void* out, void* scores, int B, int Hq, int Hkv, int D,
                                    int kv_rows, int table_cols, int pos_stride, int valid_stride,
                                    int n_cols, int window, float scale, int kv_kind,
                                    int q_bf16, int round_p, void* stream) {
  if (D % 8 != 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 64 || n_cols <= 0 ||
      !asq_row_vec_ok(8, {q, k, v}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const Args a{q,
               k,
               v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const long long*>(pos),
               static_cast<const unsigned char*>(kv_valid),
               out,
               static_cast<float*>(scores),
               Hq,
               Hkv,
               D,
               kv_rows,
               table_cols,
               pos_stride,
               valid_stride,
               n_cols,
               window,
               scale,
               round_p};
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, B, kv_kind, s) : launch_kv<float>(a, B, kv_kind, s);
}
