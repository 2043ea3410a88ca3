// Decode attention: one query token a row against its KV cache, one kernel a
// layer, over a contiguous cache or block-paged pages.
//
// Replaces what the JAX package leaves to XLA (no Pallas kernel):
// autosmoothquant_tpu/models/common.py:1255 attend at T = 1 (the decode step
// of the static and continuous engines) and :571 paged_attend at T = 1 (the
// paged engine's decode step):
//
//   s_j = (q . k_j) * scale [* k_scale_j]           (f32; int8 cache)
//         [+ m_h * j]                                (ALiBi, Baichuan-13B)
//   s_j = -1e30 unless j <= pos, j > pos - window (a sliding window) and
//         kv_valid[j] (where given)
//   p_j = exp(s_j - max s) / sum exp(s - max s) [* v_scale_j]
//         [rounded to bf16 on the bf16 path]
//   out = sum_j p_j v_j                              (f32, stored in q's dtype)
//
// with Hq / Hkv query heads sharing each kv head (GQA), D % 8 == 0 up to
// 256. An int8 cache is read raw: its per-token-per-head scales factor out
// of both products, as the eager attend factors them. ALiBi's m_h (f32 [Hq]
// slopes) multiplies the key's position j: the cache slot (contiguous) or
// the logical position j = block * bs + offset (paged), as JAX's attend
// (bias = m_h * key slot) and paged_attend (m_h * key position) add it.
//
// Layout: q and out [B, Hq, D]. Contiguous: k, v [B, S, Hkv, D] (scales [B,
// S, Hkv]), key j of row b at (b * S + j). Paged: k, v [N, bs, Hkv, D] pages
// (scales [N, bs, Hkv]), key j of row b in page table[b, j / bs] at offset
// j % bs; the block index is clamped to the table's last column, so no key
// reads past the table.
//
// What bounds it on an H100: at decode sizes, latency. TinyLlama b8 at
// kv_window 256 reads 1.05 MB a layer (0.3 us at 3.35 TB/s); the time is the
// launch, the round trips to device memory (cold after a decode step's
// GEMVs stream the weights through L2: the data, and the kernel's own code,
// whose instruction fetches cost microseconds when it is long) and the
// barriers between them, on as many SMs as the launch has blocks. At long
// contexts, bytes: Llama-3-8B's heads at b1 over 16K columns read 67 MB
// (20 us).
//
// Design: a thread-block cluster of kNC CTAs a (row, kv head), its G = Hq /
// Hkv query heads together. Keys are cut into chunks of kC consecutive
// positions, and CTA i of the cluster owns chunks i, i + kNC, i + 2 kNC, ...,
// so a row's keys spread over kNC SMs at any position (one block walked them
// all before), and at long contexts kNC SMs stream them. A CTA has 128
// threads and at most 85 registers a thread, so an SM holds 6 of them and a
// b16 decode step's 64 clusters run in one wave (the loop over a key's
// pieces of 8 columns stays rolled, so D = 256 keeps that budget; its K and
// V tiles, 16 KB a chunk in bf16, then bound the CTAs an SM holds: a b1
// Gemma step has 8 CTAs in all). A CTA whose chunks lie past
// the row's position, or before its window, scores nothing and still takes
// part in every cluster barrier. A CTA works on up to kR of its chunks at
// once (a round), its K and V rows copied to shared-memory tiles with
// cp.async:
//  0. stage: each key's cache slot (the page table read once a page: a warp
//     takes a chunk, its lanes read the chunk's pages and shuffle them to the
//     keys) and int8 scales, -1 for a key outside [window start, pos] or not
//     kv_valid. Without a window the first round's K and V rows go out
//     before the row's position has arrived (every column's; the position
//     masks them after), so one round trip to device memory brings q, the
//     position, the keys and the values;
//  1. scores: 4 lanes share a key, each dots its pieces of 8 columns with
//     every head's q (f32 in shared memory) in order of d (fmaf), then the 4
//     partial dots are added by an xor tree. The scores stay in shared
//     memory (G x the CTA's columns) while they fit, the next round's keys
//     loading while a round is scored; past that (very long contexts) the
//     two later passes recompute them with the same code and the same bits.
//     Each head's max over the CTA's keys goes to shared memory; after a
//     cluster barrier every CTA reads the kNC maxima through distributed
//     shared memory (DSMEM): the same M in all;
//  2. each CTA sums exp(s - M) over its keys (lane l of a warp takes key l
//     of each chunk, the chunks in order, then the warp's xor tree) and
//     publishes the sum; after a second cluster barrier every CTA adds the
//     kNC sums in CTA order: the same L in all;
//  3. p_j = exp(s_j - M) / L [* v_scale_j], rounded to bf16 on the bf16 path
//     as the reference rounds it, in place of the scores; then a thread owns
//     8 columns of one head and one of KG key groups (key j of a chunk in
//     group j % KG) and sums p_j v_j over its keys in order; the KG partial
//     sums are added in group order, and after a third cluster barrier each
//     CTA adds a slice of the outputs over the kNC CTAs in CTA order through
//     DSMEM and stores it. A last cluster barrier keeps every CTA's shared
//     memory alive until its peers have read it.
// The loops over rounds, keys and a key's pieces of 8 columns stay rolled
// (the 8 heads of a score group and the 8 columns of a piece are unrolled):
// the kernel's code is fetched cold at every decode step, and an unrolled
// body cost more in instruction fetches than its loops saved.
// Why the fold waits for M and L: on the bf16 path the reference rounds the
// normalised probabilities to bf16 before the value product, so partial
// outputs of unnormalised probabilities, rescaled at the end (a plain
// flash-decoding split), compute another function there. The cluster makes
// the global M and L known inside one launch, with no workspace, no atomics
// and no second kernel.
//
// Batch invariance: every sum above runs in an order set by the absolute key
// position, G, D and the constants kC, kNC and kThreads, and by nothing
// else. A round groups chunks without reordering any sum (kR = 1 gave
// kR = 4's bits at every timing shape on an H100, PERF.md PR 13), and a
// row's rounds do not change with kv_window anyway: a CTA holding at most
// kR of the row's chunks takes them in one round, one holding more takes
// rounds of kR. A key a call does not scan adds an exact 0 where it would
// stand, so a row's output has the same bits alone and in any batch,
// bounded by kv_window or by S, contiguous or paged, with its scores kept
// or recomputed.
//
// A round's K and V tiles hold kR = 4 chunks while a key row is at most 512
// bytes (f32 at D 128, bf16 at D 256: 64 KB a tile), fewer past that (f32 at
// D 256: 2), so that the recomputing route's two tiles always fit the
// shared memory.
//
// kNC = 8, the portable cluster size. A cluster of 16 (the non-portable
// opt-in) was measured against it on an H100: faster only past a few
// thousand columns, and slower at every decode shape of the engines, whose
// launches it doubles (PERF.md, PR 13).

#include <cooperative_groups.h>

#include "asq_common.cuh"
#include "asq_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNC = 8;              // CTAs of a cluster (the portable most)
constexpr int kC = 32;              // keys a chunk: consecutive positions
constexpr int kR = 4;               // most chunks of a CTA a round
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;             // CTAs an SM holds (<= 85 registers a thread)
constexpr int kKeyLanes = kThreads / kC;  // lanes that share one key's dot
constexpr int kMaxDc = 32 / kKeyLanes;    // a lane's 8-column pieces of a key (D <= 256)
constexpr int kMaxD = 256;
constexpr int kHeadGroup = 8;             // heads a score pass keeps in registers
constexpr int kMaxHeads = 64;
constexpr float kMasked = -1e30f;
static_assert(kC == 32 && kR <= kWarps && kKeyLanes <= kHeadGroup &&
                  (kKeyLanes & (kKeyLanes - 1)) == 0,
              "the passes' thread maps");
static_assert(kNC >= 1 && kNC <= 8, "a portable cluster has at most 8 CTAs");

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
  const float* slopes;            // ALiBi, f32 [Hq]; null: none
  void* out;
  int Hq, Hkv, D;
  int kv_rows;     // contiguous: S; paged: the page size bs
  int table_cols;  // paged: the table's columns
  int pos_stride, valid_stride;
  int n_cols;  // the columns scanned (kv_window)
  int window;  // sliding window; 0: none
  float scale;
  int round_p;  // round the probabilities to bf16 before the value product
  int keep;     // the scores stay in shared memory (else recomputed)
  int round;    // chunks of a CTA a round
  int tiles;    // K and V tiles of a round: 3 where kept scores span several rounds, else 2
  int rowlen;   // keys a CTA's score rows hold: kept, all its columns; else a round's
};

// The key groups of the value pass: G x D / 8 (head, 8 columns) pairs, and
// as many groups as the block has threads for (a power of two, <= kC).
__host__ __device__ inline int key_groups(int G, int D) {
  const int pairs = G * (D / 8);
  int kg = 1;
  while (kg < kC && 2 * kg * pairs <= kThreads) kg *= 2;
  return kg;
}

// The chunks of a CTA a round: as many as a CTA has over n_cols columns, at
// most kR, and fewer where a key row (D * elt bytes) passes 512 bytes (a
// shape's constant: the rounds do not change the sums' order).
inline int round_chunks(int n_cols, int D, int elt) {
  const int chunks = (n_cols + kC - 1) / kC;
  const int per_cta = (chunks + kNC - 1) / kNC;
  const int row_bytes = D * elt, most = row_bytes > 512 ? (kR * 512) / row_bytes : kR;
  const int cap = most < 1 ? 1 : most;
  return per_cta < cap ? per_cta : cap;
}

// The rows a CTA's scores take: all its columns, or a round's.
inline int score_rowlen(int n_cols, bool keep, int D, int elt) {
  const int chunks = (n_cols + kC - 1) / kC;
  return keep ? (chunks + kNC - 1) / kNC * kC : round_chunks(n_cols, D, elt) * kC;
}

// The floats of the value pass's key-group partials, which pass 2's lane
// sums (32 a head) use before them.
__host__ __device__ inline int partial_floats(int G, int D) {
  const int parts = key_groups(G, D) * G * D;
  return parts > 32 * G ? parts : 32 * G;
}

// The tiles of a round's K and V rows: a third where the scores are kept
// over several rounds, so the next round's rows load while one is used.
inline int round_tiles(int n_cols, bool keep, int D, int elt) {
  const int chunks = (n_cols + kC - 1) / kC;
  return keep && (chunks + kNC - 1) / kNC > round_chunks(n_cols, D, elt) ? 3 : 2;
}

// The dynamic shared memory of a launch: the tiles of K and V rows (elt
// bytes an element), then in floats and ints: q (then the CTA's output), the
// partials, the maxima and sums published and folded, the score rows (one
// padding column each) and each key's slot and int8 scales.
size_t smem_bytes(int G, int D, int round, int tiles, int rowlen, int elt) {
  return static_cast<size_t>(tiles) * round * kC * D * elt +
         4 * (static_cast<size_t>(G) * D + partial_floats(G, D) + 4 * kMaxHeads +
              static_cast<size_t>(G) * (rowlen + 1) + 3 * static_cast<size_t>(rowlen));
}

// the bytes of a cache element
template <int K>
struct Elt {
  static constexpr int kBytes = K == KV_F32 ? 4 : K == KV_BF16 ? 2 : 1;
};

// 8 consecutive cache elements as stored (16 bytes of bf16, 32 of f32, 8 of
// int8), read from shared memory and widened to f32
template <int K>
__device__ __forceinline__ void lds8(const unsigned char* p, float (&x)[8]) {
  if constexpr (K == KV_F32) {
    asq_load8(reinterpret_cast<const float*>(p), x);
  } else if constexpr (K == KV_BF16) {
    asq_load8(reinterpret_cast<const __nv_bfloat16*>(p), x);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xff));
  }
}

// 8 elements of a cache row, global to shared, asynchronously; zeros
// where !valid (src is then not read)
template <int K>
__device__ __forceinline__ void copy8(uint32_t dst, const unsigned char* src, bool valid) {
  if constexpr (K == KV_F32) {
    cp_async16(dst, src, valid);
    cp_async16(dst + 16, src + 16, valid);
  } else if constexpr (K == KV_BF16) {
    cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ float4 load_float4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename Tq>
__device__ __forceinline__ void store4(Tq* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename Tq, int K>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
    decode_attn_kernel(const Args a) {
  constexpr int kElt = Elt<K>::kBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / kNC, Hkv = a.Hkv;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = a.Hq / Hkv, D = a.D, ND = D / 8, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int R = a.round, rowlen = a.rowlen, stride = rowlen + 1;
  const int KG = key_groups(G, D);
  // tiles of [R][kC][D]: t0 a round's keys (and, over several kept rounds,
  // every other round's values in pass 3), t1 the next round's keys (three
  // tiles), v_tile the first round's values
  const int tile_bytes = R * kC * D * kElt;
  unsigned char* t0 = smem;
  unsigned char* t1 = t0 + tile_bytes;
  unsigned char* v_tile = t0 + (a.tiles - 1) * tile_bytes;
  const bool pipelined = a.tiles == 3;
  float* q_s = reinterpret_cast<float*>(t0 + a.tiles * tile_bytes);  // [G][D] q, then the output
  float* o_part = q_s + G * D;       // [KG][G][D] pass 3's partials
  float* l_lane = o_part;            // [G][32] pass 2's running lane sums
  float* m_s = o_part + partial_floats(G, D);  // each head's max over the CTA's keys
  float* l_s = m_s + kMaxHeads;      // its sum of exp(s - M)
  float* mg_s = l_s + kMaxHeads;     // the cluster's M
  float* lg_s = mg_s + kMaxHeads;    // the cluster's L
  float* s_buf = lg_s + kMaxHeads;   // [G][stride] scores
  int* slot_s = reinterpret_cast<int*>(s_buf + G * stride);  // [rowlen]; -1: not scanned
  float* ks_s = reinterpret_cast<float*>(slot_s + rowlen);   // [rowlen] int8 scales
  float* vs_s = ks_s + rowlen;

  // (the kernel's parameters are copied out first: taking their address
  // would move them to local memory)
  const int* table = a.table == nullptr ? nullptr : a.table + static_cast<size_t>(b) * a.table_cols;
  const unsigned char* valid =
      a.kv_valid == nullptr ? nullptr : a.kv_valid + static_cast<size_t>(b) * a.valid_stride;
  const int kv_rows = a.kv_rows, last_col = a.table_cols - 1, n_cols = a.n_cols;
  const int window = a.window;
  const bool keep = a.keep != 0, round_p = a.round_p != 0;
  const float scale = a.scale;
  const unsigned char* const kbase = static_cast<const unsigned char*>(a.k);
  const unsigned char* const vbase = static_cast<const unsigned char*>(a.v);
  const float* const k_scale = a.k_scale;
  const float* const v_scale = a.v_scale;
  const size_t kv_head = static_cast<size_t>(h) * D;
  const float* const slopes = a.slopes == nullptr ? nullptr : a.slopes + h * G;
  // this CTA's chunk c = rank + kNC * lc; its first one with a key at or
  // after j0
  auto first_lc = [&](int j0) {
    const int c_lo = j0 / kC;
    return c_lo <= rank ? 0 : (c_lo - rank + kNC - 1) / kNC;
  };
  // where a round's keys sit in the score rows
  auto base_of = [&](int lc0) { return keep ? lc0 * kC : 0; };

  // A round's keys: warp u < R takes chunk lc0 + u, lane l its key l. The
  // slot of key j = (rank + kNC (lc0 + u)) kC + l in [lo, hi), else -1: a
  // warp reads its chunk's pages from the table, one lane a page, and
  // shuffles them to the keys
  auto key_slot = [&](int lc0, int lo, int hi) {
    const int c0 = (rank + kNC * (lc0 + warp)) * kC, j = c0 + lane;
    if (c0 >= hi) return -1;  // uniform in a warp
    int page = 0;
    if (table != nullptr) {
      const int first = c0 / kv_rows, count = (c0 + kC - 1) / kv_rows - first + 1;
      const int mine = lane < count ? table[min(first + lane, last_col)] : 0;
      page = __shfl_sync(0xffffffffu, mine, j / kv_rows - first);
    }
    if (j < lo || j >= hi) return -1;
    return table != nullptr ? page * kv_rows + j % kv_rows : b * kv_rows + j;
  };
  // key (warp, lane)'s K or V row into its tile row (zeros for a key not
  // scanned: its probability is 0, and 0 x 0 adds nothing where the value
  // pass reads it)
  auto fetch = [&](const unsigned char* cache, unsigned char* tile, int slot) {
    const bool ok = slot >= 0;
    const unsigned char* src =
        cache + (ok ? (static_cast<size_t>(slot) * Hkv * D + kv_head) * kElt : 0);
    const uint32_t dst = smem_u32(tile + (warp * kC + lane) * D * kElt);
    for (int dc = 0; dc < ND; ++dc) copy8<K>(dst + 8 * dc * kElt, src + 8 * dc * kElt, ok);
  };
  // its int8 scales into entry idx, staged with its slot (with the keys'
  // commit group, so that pass 3 can read a round's value scales before
  // its values have landed)
  auto stage_scales = [&](int idx, int slot) {
    if (K != KV_INT8) return;
    if (slot >= 0) {
      const size_t at = static_cast<size_t>(slot) * Hkv + h;
      cp_async4(smem_u32(ks_s + idx), k_scale + at);
      cp_async4(smem_u32(vs_s + idx), v_scale + at);
    } else {
      ks_s[idx] = vs_s[idx] = 0.f;
    }
  };

  // The first round goes out before the row's position is known (without a
  // window it starts at the CTA's first chunk): every column's K and V rows
  // are fetched, and the keys the position, the window or kv_valid leave out
  // are masked once it arrives
  const long long p = a.pos[static_cast<size_t>(b) * a.pos_stride];
  int lc_first = 0;
  if (window > 0) lc_first = first_lc(static_cast<int>(max(0LL, p - window + 1)));
  int slot0 = -1;
  bool valid0 = true;
  const int idx0 = base_of(lc_first) + warp * kC + lane;
  const int j_first = (rank + kNC * (lc_first + warp)) * kC + lane;
  // (a chunk past the columns has no place in the score rows)
  const bool chunk0 = warp < R && j_first - lane < n_cols;
  if (chunk0) {
    slot0 = key_slot(lc_first, 0, n_cols);
    fetch(kbase, t0, slot0);
    stage_scales(idx0, slot0);
  }
  cp_async_commit();
  if (chunk0) {
    fetch(vbase, v_tile, slot0);
    if (valid != nullptr && slot0 >= 0) valid0 = valid[j_first];
  }
  cp_async_commit();
  const Tq* q = static_cast<const Tq*>(a.q) + (static_cast<size_t>(b) * a.Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = asq_to_float(q[i]);
  // keys [j0, n) are scanned; this CTA's chunks among them: lc in [lc_lo, lc_hi)
  const int n = static_cast<int>(min(static_cast<long long>(n_cols), p + 1));
  const int j0 = window > 0 ? static_cast<int>(max(0LL, p - window + 1)) : 0;
  int lc_lo = 0, lc_hi = 0;
  if (n > j0) {
    const int c_hi = (n - 1) / kC;
    lc_lo = first_lc(j0);
    lc_hi = c_hi < rank ? 0 : (c_hi - rank) / kNC + 1;
  }
  if (chunk0) slot_s[idx0] = slot0 >= 0 && j_first >= j0 && j_first < n && valid0 ? slot0 : -1;
  cp_async_wait<1>();  // the first round's keys (its values may still be on the way)
  __syncthreads();

  // a later round's keys into tile kt (restaged: their slots and scales
  // anew) or values into tile vt (null: not wanted), one commit group
  auto issue_round = [&](int lc0, bool restage, unsigned char* kt, unsigned char* vt) {
    if (warp < R && lc0 + warp < lc_hi) {
      const int idx = base_of(lc0) + warp * kC + lane;
      int slot = slot_s[idx];
      if (restage) {
        slot = key_slot(lc0, j0, n);
        const int j = (rank + kNC * (lc0 + warp)) * kC + lane;
        if (slot >= 0 && valid != nullptr && !valid[j]) slot = -1;
        slot_s[idx] = slot;
        stage_scales(idx, slot);
      }
      if (kt != nullptr) fetch(kbase, kt, slot);
      if (vt != nullptr) fetch(vbase, vt, slot);
    }
    cp_async_commit();
  };
  // the same, waited for, the tiles' last round consumed first
  auto load_round = [&](int lc0, unsigned char* kt, unsigned char* vt) {
    __syncthreads();
    issue_round(lc0, true, kt, vt);
    cp_async_wait<0>();
    __syncthreads();
  };

  // 1. the scores of a round (its keys in tile kt) into the score rows:
  // kKeyLanes lanes a key, lane kl dotting pieces kl, kl + kKeyLanes, ... of
  // 8 columns with every head's q in order of d (fmaf), then an xor tree
  // over the lanes (every lane gets the same bits); lane kl stores the heads
  // g with g % kKeyLanes == kl
  const int key = tid / kKeyLanes, kl = tid % kKeyLanes;
  auto scores = [&](int lc0, const unsigned char* kt) {
    const int base = base_of(lc0), nu = min(R, lc_hi - lc0);
    for (int u = 0; u < nu; ++u) {
      const int idx = base + u * kC + key;
      const unsigned char* krow = kt + (u * kC + key) * D * kElt;
      for (int g0 = 0; g0 < G; g0 += kHeadGroup) {
        float acc[kHeadGroup];
#pragma unroll
        for (int g = 0; g < kHeadGroup; ++g) acc[g] = 0.f;
#pragma unroll 1
        for (int i = 0; i < kMaxDc; ++i) {
          const int dc = kl + kKeyLanes * i;
          if (dc >= ND) break;
          float x[8];
          lds8<K>(krow + 8 * dc * kElt, x);
#pragma unroll
          for (int g = 0; g < kHeadGroup; ++g) {
            if (g0 + g >= G) break;
            float qv[8];
            asq_load8(q_s + (g0 + g) * D + 8 * dc, qv);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g] = fmaf(qv[e], x[e], acc[g]);
          }
        }
        const bool ok = slot_s[idx] >= 0;
        const float ks = K == KV_INT8 ? ks_s[idx] : 1.f;
#pragma unroll
        for (int g = 0; g < kHeadGroup; ++g) {
          if (g0 + g >= G) break;
#pragma unroll
          for (int o = kKeyLanes / 2; o > 0; o >>= 1)
            acc[g] = __fadd_rn(acc[g], __shfl_xor_sync(0xffffffffu, acc[g], o));
          if (g % kKeyLanes == kl) {
            float s = __fmul_rn(acc[g], scale);
            if (K == KV_INT8) s = __fmul_rn(s, ks);
            if (slopes != nullptr) {  // m_h * j, j the key's position
              const int j = (rank + kNC * (lc0 + u)) * kC + key;
              s = __fadd_rn(s, __fmul_rn(slopes[g0 + g], static_cast<float>(j)));
            }
            s_buf[(g0 + g) * stride + idx] = ok ? s : kMasked;
          }
        }
      }
    }
  };

  // pass 1: scores, and each head's max over the CTA's keys (warp w takes
  // heads w, w + kWarps, ...; max is exact in any order)
  for (int g = warp; g < G; g += kWarps)
    if (lane == 0) m_s[g] = kMasked;
  for (int lc0 = lc_lo, r = 0; lc0 < lc_hi; lc0 += R, ++r) {
    unsigned char* kt = pipelined && (r & 1) ? t1 : t0;
    if (pipelined) {
      // the next round's keys go out before this round's are scored
      const bool more = lc0 + R < lc_hi;
      if (more) issue_round(lc0 + R, true, r & 1 ? t0 : t1, nullptr);
      if (r > 0) {
        if (more) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncthreads();
      }
    } else if (r > 0) {
      load_round(lc0, t0, nullptr);
    }
    scores(lc0, kt);
    __syncthreads();
    const int base = base_of(lc0), nu = min(R, lc_hi - lc0);
    for (int g = warp; g < G; g += kWarps) {
      float mx = kMasked;
      for (int u = 0; u < nu; ++u) mx = fmaxf(mx, s_buf[g * stride + base + u * kC + lane]);
      mx = asq_warp_max(mx);
      if (lane == 0) m_s[g] = fmaxf(m_s[g], mx);
    }
  }
  cluster.sync();
  // the cluster's max of each head, read through DSMEM: the same in every CTA
  for (int g = warp; g < G; g += kWarps) {
    const float mx = asq_warp_max(lane < kNC ? *cluster.map_shared_rank(m_s + g, lane) : kMasked);
    if (lane == 0) mg_s[g] = mx;
  }
  __syncwarp();

  // pass 2: each head's sum of exp(s - M) over the CTA's keys: lane l adds
  // key l of each chunk in chunk order (its running sum in l_lane between
  // rounds), then the warp's xor tree
  for (int lc0 = lc_lo; lc0 < lc_hi; lc0 += R) {
    if (!keep) {
      load_round(lc0, t0, nullptr);
      scores(lc0, t0);
      __syncthreads();
    }
    const int base = base_of(lc0), nu = min(R, lc_hi - lc0);
    for (int g = warp; g < G; g += kWarps) {
      const float mx = mg_s[g];
      float t = lc0 == lc_lo ? 0.f : l_lane[g * 32 + lane];
      for (int u = 0; u < nu; ++u)
        t = __fadd_rn(t, expf(s_buf[g * stride + base + u * kC + lane] - mx));
      l_lane[g * 32 + lane] = t;
    }
  }
  for (int g = warp; g < G; g += kWarps) {
    const float t = asq_warp_sum(lc_lo < lc_hi ? l_lane[g * 32 + lane] : 0.f);
    if (lane == 0) l_s[g] = t;
  }
  cluster.sync();
  // the cluster's sum of each head: the kNC sums added in CTA order
  for (int g = warp; g < G; g += kWarps) {
    const float mine = lane < kNC ? *cluster.map_shared_rank(l_s + g, lane) : 0.f;
    float t = __shfl_sync(0xffffffffu, mine, 0);
#pragma unroll
    for (int r = 1; r < kNC; ++r) t = __fadd_rn(t, __shfl_sync(0xffffffffu, mine, r));
    if (lane == 0) lg_s[g] = t;
  }
  cp_async_wait<0>();  // the first round's values
  __syncthreads();

  // pass 3: a round's p_j = exp(s_j - M) / L [* v_scale_j], rounded to bf16
  // on the bf16 path, in place of its scores; then each thread owns (head g,
  // columns 8 dc .. 8 dc + 7) pairs and a key group (key kc of a chunk in
  // group kc % KG), and sums p_j v_j over its keys in order, its running sums
  // in o_part between rounds (the fmaf chain goes on from where the last
  // round stored it)
  const int pairs = G * ND;
  const int vkg = pairs >= kThreads ? 0 : tid / pairs;
  const int npairs = pairs >= kThreads ? (pairs - tid + kThreads - 1) / kThreads
                                       : (vkg < KG ? 1 : 0);
  auto pair_of = [&](int k) { return pairs >= kThreads ? tid + k * kThreads : tid % pairs; };
  for (int k = 0; k < npairs; ++k) {
    float* o = o_part + static_cast<size_t>(vkg) * G * D + pair_of(k) * 8;
    *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(o + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int lc0 = lc_lo, r = 0; lc0 < lc_hi; lc0 += R, ++r) {
    // the first round's values came with its keys, into v_tile; kept
    // scores over several rounds: round r's values in t0 (r odd) or v_tile
    // (r even), the next round's going out before this one's are used.
    // (Kept scores without a third tile span one round: round_chunks takes
    // all of a CTA's chunks when they are at most kR.)
    unsigned char* vt = pipelined && (r & 1) ? t0 : v_tile;
    bool more = false;
    if (!keep) {
      load_round(lc0, t0, r > 0 ? v_tile : nullptr);
      scores(lc0, t0);
      __syncthreads();
    } else if (pipelined) {
      if (r > 0) __syncthreads();  // round r - 1's values are used
      more = lc0 + R < lc_hi;
      if (more) issue_round(lc0 + R, false, nullptr, r & 1 ? v_tile : t0);
    }
    const int base = base_of(lc0), nu = min(R, lc_hi - lc0);
    for (int i = tid; i < G * nu * kC; i += kThreads) {
      const int g = i / (nu * kC), idx = base + i % (nu * kC);
      float pr = expf(s_buf[g * stride + idx] - mg_s[g]) / lg_s[g];
      if (K == KV_INT8) pr = __fmul_rn(pr, vs_s[idx]);
      if (round_p) pr = __bfloat162float(__float2bfloat16_rn(pr));
      s_buf[g * stride + idx] = pr;
    }
    if (pipelined && r > 0) {
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();
    for (int k = 0; k < npairs; ++k) {
      const int pair = pair_of(k), g = pair / ND, dc = pair % ND;
      float* o = o_part + static_cast<size_t>(vkg) * G * D + pair * 8;
      float acc[8];
      asq_load8(o, acc);
      // a key not scanned has p_j = 0 and, unless it was fetched before the
      // position was known, zeros in the tile: either way it adds nothing
      for (int u = 0; u < nu; ++u) {
#pragma unroll 4
        for (int kc = vkg; kc < kC; kc += KG) {
          const int idx = base + u * kC + kc;
          const float pr = s_buf[g * stride + idx];
          float v8[8];
          lds8<K>(vt + ((u * kC + kc) * D + 8 * dc) * kElt, v8);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(pr, v8[e], acc[e]);
        }
      }
      asq_store8(o, acc);
    }
  }
  // the key groups' partial outputs added in group order, into q_s
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float t = o_part[i];
    for (int kg = 1; kg < KG; ++kg) t = __fadd_rn(t, o_part[static_cast<size_t>(kg) * G * D + i]);
    q_s[i] = t;
  }
  cluster.sync();

  // this CTA's slice of the outputs: the kNC CTAs' partials added in CTA
  // order through DSMEM, 4 columns a thread
  Tq* out = static_cast<Tq*>(a.out) + (static_cast<size_t>(b) * a.Hq + h * G) * D;
  const int per = (G * D / 4 + kNC - 1) / kNC * 4;
  const int end = min(G * D, (rank + 1) * per);
  for (int i = rank * per + 4 * tid; i < end; i += 4 * kThreads) {
    float4 t = load_float4(cluster.map_shared_rank(q_s, 0) + i);
#pragma unroll
    for (int r = 1; r < kNC; ++r) {
      const float4 o = load_float4(cluster.map_shared_rank(q_s, r) + i);
      t = make_float4(__fadd_rn(t.x, o.x), __fadd_rn(t.y, o.y), __fadd_rn(t.z, o.z),
                      __fadd_rn(t.w, o.w));
    }
    // a row with no valid key (every score masked) is written as 0
    if (n <= j0 || mg_s[i / D] <= kMasked) t = make_float4(0.f, 0.f, 0.f, 0.f);
    store4<Tq>(out + i, t);
  }
  cluster.sync();  // no CTA leaves while a peer may read its shared memory
}

// The dynamic shared memory a block of decode_attn_kernel<Tq, K> may have,
// granted to it once, at the first call (an eager step, never inside a
// graph capture); 0 with the error in *err if the grant failed.
template <typename Tq, int K>
int granted(cudaError_t* err) {
  static int most = -1;
  if (most < 0) {
    cudaFuncAttributes attr;
    int device = 0, optin = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, decode_attn_kernel<Tq, K>);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_attn_kernel<Tq, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    *err = e;
    if (e != cudaSuccess) return 0;
    most = limit;
  }
  *err = cudaSuccess;
  return most;
}

// Whether a launch keeps its score rows in shared memory: where they fit in
// the `most` bytes the kernel was granted, a choice by shape alone (either
// route gives the same bits)
inline bool keeps(int G, int D, int n_cols, int elt, int most) {
  return smem_bytes(G, D, round_chunks(n_cols, D, elt), round_tiles(n_cols, true, D, elt),
                    score_rowlen(n_cols, true, D, elt), elt) <= static_cast<size_t>(most);
}

// keeps() for decode_attn_kernel<Tq, K>: 1 or 0, or a negative cudaError_t
template <typename Tq, int K>
int keeps_scores(int G, int D, int n_cols) {
  cudaError_t e;
  const int most = granted<Tq, K>(&e);
  return e != cudaSuccess ? -static_cast<int>(e) : keeps(G, D, n_cols, Elt<K>::kBytes, most);
}

template <typename Tq, int K>
int launch(Args a, int B, bool recompute, cudaStream_t s) {
  cudaError_t e;
  const int most = granted<Tq, K>(&e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = a.Hq / a.Hkv;
  const bool keep = !recompute && keeps(G, a.D, a.n_cols, Elt<K>::kBytes, most);
  constexpr int kElt = Elt<K>::kBytes;
  a.keep = keep;
  a.round = round_chunks(a.n_cols, a.D, kElt);
  a.tiles = round_tiles(a.n_cols, keep, a.D, kElt);
  a.rowlen = score_rowlen(a.n_cols, keep, a.D, kElt);
  const size_t smem = smem_bytes(G, a.D, a.round, a.tiles, a.rowlen, Elt<K>::kBytes);
  if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_kernel<Tq, K><<<kNC * B * a.Hkv, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tq>
int launch_kv(const Args& a, int B, int kv_kind, bool recompute, cudaStream_t s) {
  if (kv_kind == KV_F32) return launch<Tq, KV_F32>(a, B, recompute, s);
  if (kv_kind == KV_BF16) return launch<Tq, KV_BF16>(a, B, recompute, s);
  return launch<Tq, KV_INT8>(a, B, recompute, s);
}

template <typename Tq>
int keeps_kv(int G, int D, int n_cols, int kv_kind) {
  if (kv_kind == KV_F32) return keeps_scores<Tq, KV_F32>(G, D, n_cols);
  if (kv_kind == KV_BF16) return keeps_scores<Tq, KV_BF16>(G, D, n_cols);
  return keeps_scores<Tq, KV_INT8>(G, D, n_cols);
}

}  // namespace

// q, out [B, Hq, D] (q_bf16: bf16, else f32); k, v and k_scale, v_scale
// (f32, int8 caches only, else null) as the note above lays them out;
// table int32 [B, table_cols] (paged) or null (contiguous); pos int64, row
// b's at pos[b * pos_stride]; kv_valid bool [B, valid_stride] or null;
// slopes f32 [Hq] (ALiBi) or null.
// kv_kind: 0 f32, 1 bf16, 2 int8. The score rows stay in shared memory
// where they fit (asq_decode_keeps_scores), unless recompute (for tests:
// the other route, the same bits). Needs D % 8 == 0, D <= 256, Hq % Hkv ==
// 0, Hq / Hkv <= 64 and 16-byte aligned q, k and v.
ASQ_EXPORT int asq_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* table, const void* pos, const void* kv_valid,
                                    const void* slopes, void* out, int B, int Hq, int Hkv, int D, int kv_rows,
                                    int table_cols, int pos_stride, int valid_stride,
                                    int n_cols, int window, float scale, int kv_kind,
                                    int q_bf16, int round_p, int recompute, void* stream) {
  if (D % 8 != 0 || D > kMaxD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxHeads ||
      n_cols <= 0 || kv_rows <= 0 || !asq_row_vec_ok(8, {q, k, v}))
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
               static_cast<const float*>(slopes),
               out,
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
               round_p,
               0,
               0,
               0,
               0};
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, B, kv_kind, recompute != 0, s)
                : launch_kv<float>(a, B, kv_kind, recompute != 0, s);
}

// Whether a launch at these shapes keeps its score rows in shared memory
// (1) or recomputes them (0); a negative cudaError_t if the kernel's
// shared memory could not be granted. Grants it, so call it outside a
// graph capture.
ASQ_EXPORT int asq_decode_keeps_scores(int G, int D, int n_cols, int kv_kind, int q_bf16) {
  return q_bf16 ? keeps_kv<__nv_bfloat16>(G, D, n_cols, kv_kind)
                : keeps_kv<float>(G, D, n_cols, kv_kind);
}
