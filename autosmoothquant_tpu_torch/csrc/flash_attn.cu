// K3: banded-causal flash attention (forward) for prefill.
//
// Replaces two TPU kernels of autosmoothquant_tpu/kernels/attention.py:
//   _flash_kernel        (pallas_call in flash_attention): causal prefill
//   _flash_banded_kernel (pallas_call in flash_attention_banded): chunked /
//                        ragged prefill against full cache rows
// One kernel serves both. Query i of row b sits at cache slot pos[b] + i and
// attends key columns [starts[b], pos[b] + i] (all columns when not causal);
// causal prefill is pos = starts = 0 with S = T.
//
//   q [B, T, Hq, D], k/v [B, S, Hkv, D], out [B, T, Hq, D]; f32 or bf16;
//   GQA: query head h reads kv head h / (Hq / Hkv); D <= 256 (a multiple of
//   8 for bf16; the wrapper zero-pads any other D to one).
//
// ALiBi (Baichuan-13B, Baichuan-2-13B): with per-query-head slopes m_h (f32
// [Hq], else null) every score gains m_h * (key column) after the scale and
// before the mask, the shift-invariant form of m_h * (key - query) that the
// JAX package adds (models/baichuan.py: bias = m_h * key slot). The key
// column is the cache slot the kernel walks (banded: the slot in the cache
// row; causal prefill: the position).
//
// The kernels are built for a compute width DP of 64, 128 or 256 and read any
// D <= DP as it lies: columns D .. DP of the shared-memory tiles are zero
// (they add 0 to every score, and their output columns are not stored), so
// OPT-2.7B's D = 80 runs the DP = 128 kernel with no padded copy of q, k, v
// (three padded copies took twice the kernel's own time on an H100,
// chip_smoke.py's K3 timing row at D = 80).
//
// What bounds it on an H100: at prefill lengths it is the score and value
// products, 4 * B * Hq * (band area) * D operations (989 TFLOP/s bf16 on the
// tensor cores); the bytes are q, k, v and out read or written once. At
// TinyLlama's B1 T128 the work is ~67 MFLOP and the kernel is latency-bound.
//
// Both routes share the row space: a block owns one (batch row, kv head) and
// 64 consecutive rows of the flattened (position, group head) query space, so
// each K/V tile it stages in shared memory is shared by all Hq / Hkv query
// heads of the group, as the TPU kernel's head-inner grid shares them. Tiles
// outside the block's band are never loaded. A row with no valid column ends
// with sum 0 and is written as 0 (the JAX kernel's l == 0 rule).
//
// bf16 (the main path): the FlashAttention-2 structure on mma.sync.
//  - 4 warps x 16 query rows. Q fragments stay in registers (ldmatrix once).
//  - 64-key K/V tiles double-buffered in shared memory with cp.async (16-byte
//    copies, rows XOR-swizzled by 16-byte chunk so ldmatrix is conflict-free;
//    keys past S are zero-filled).
//  - S = Q K^T on mma.sync.m16n8k16 bf16 with f32 accumulation, operands by
//    ldmatrix; the online softmax runs on the accumulator fragments (row max
//    and sum across the 4 threads of a quad by shuffles, exp2f with log2(e)
//    folded into the scale); P is rounded to bf16 and fed from registers as
//    the A operand of O += P V, V loaded with ldmatrix.trans.
//  - Each row masks its own columns (an m16 tile spans 2 positions x 8 heads
//    at G = 8, 16 positions at G = 1); a warp skips a tile past its rows'
//    band, while loads and barriers stay block-wide.
//  - Blocks with the most causal tiles are launched first.
//  mma.sync and not wgmma: at the main path's prefill lengths (T 128-512) a
//  (batch, kv head) holds 128-4,096 query rows; a 64-row warpgroup fed by a
//  TMA producer buys little there and costs much more code.
//
// Width 256 (Gemma's head dim): the O accumulator doubles to 128 registers
// a thread, so the bf16 route keeps Q in shared memory (its fragments read
// with ldmatrix at every key tile instead of held in 64 more registers) and
// takes 32-key tiles (half the score and P fragments): 98 KB of shared
// memory a block, granted by the opt-in attribute.
//
// f32 (calibration; the serving path computes in bf16): tensor cores would
// round to TF32, so f32 keeps the CUDA-core kernel: 8 warps x 8 rows, 32-key
// tiles converted to f32 in shared memory, one lane scores one key, the PV
// product a shuffle-broadcast FMA loop (128 KB of shared memory at D = 256).

#include <math.h>

#include "asq_common.cuh"
#include "asq_tma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per shared-memory tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * D + 2 * kKeys * (D + 1));
}

// f32: CUDA cores
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const int* __restrict__ pos, const int* __restrict__ starts,
                 const float* __restrict__ slopes, int T_, int S, int Hq, int Hkv, int dh,
                 float scale, int causal) {
  constexpr int DL = D / 32;  // accumulator columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                    // [kRows][D]
  float* ks = qs + kRows * D;          // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);    // [kKeys][D + 1]

  const int G = Hq / Hkv;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const long long rows_total = static_cast<long long>(T_) * G;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos != nullptr ? pos[b] : 0;
  const int st = starts != nullptr ? starts[b] : 0;

  for (int i = threadIdx.x; i < kRows * D; i += kWarps * 32) {
    const int r = i / D, d = i % D;
    const long long gr = r0 + r;
    float val = 0.f;
    if (gr < rows_total && d < dh) {
      const int t = static_cast<int>(gr / G), g = static_cast<int>(gr % G);
      val = q[((static_cast<long long>(b) * T_ + t) * Hq + kvh * G + g) * dh + d];
    }
    qs[i] = val;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_i[rr] = -INFINITY;
    l_i[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[rr][c] = 0.f;
  }

  // key columns any row of this block may need
  const long long r_last = min(r0 + kRows, rows_total) - 1;
  const int t_hi = static_cast<int>(r_last / G);
  const int col_hi = causal ? min(p + t_hi, S - 1) : S - 1;
  const int col_lo = causal ? max(st, 0) : 0;
  __syncthreads();

  for (int j0 = (col_lo / kKeys) * kKeys; j0 <= col_hi; j0 += kKeys) {
    for (int i = threadIdx.x; i < kKeys * D; i += kWarps * 32) {
      const int j = i / D, d = i % D, col = j0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (col < S && d < dh) {
        const long long a = ((static_cast<long long>(b) * S + col) * Hkv + kvh) * dh + d;
        kv_k = k[a];
        kv_v = v[a];
      }
      ks[j * (D + 1) + d] = kv_k;
      vs[j * (D + 1) + d] = kv_v;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long long gr = r0 + r;
      if (gr >= rows_total) continue;
      const int t = static_cast<int>(gr / G);
      const int hi = causal ? min(p + t, S - 1) : S - 1;
      const int lo = col_lo;
      if (j0 > hi || j0 + kKeys - 1 < lo) continue;  // tile outside this row's band
      const int col = j0 + lane;
      float s = -INFINITY;
      if (col >= lo && col <= hi) {
        const float* qr = qs + r * D;
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = __fmul_rn(dot, scale);
        if (slopes != nullptr)
          s = __fadd_rn(s, __fmul_rn(slopes[kvh * G + static_cast<int>(gr % G)],
                                     static_cast<float>(col)));
      }
      const float m_new = fmaxf(m_i[rr], asq_warp_max(s));
      if (m_new == -INFINITY) continue;
      const float alpha = expf(m_i[rr] - m_new);  // exp(-inf) = 0 on the first tile
      const float pj = s == -INFINITY ? 0.f : expf(s - m_new);
      l_i[rr] = l_i[rr] * alpha + asq_warp_sum(pj);
      m_i[rr] = m_new;
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[rr][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        const float* vr = vs + j * (D + 1) + lane;
#pragma unroll
        for (int c = 0; c < DL; ++c) acc[rr][c] = fmaf(pb, vr[32 * c], acc[rr][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long gr = r0 + warp * kRowsPerWarp + rr;
    if (gr >= rows_total) continue;
    const int t = static_cast<int>(gr / G), g = static_cast<int>(gr % G);
    const float inv = l_i[rr] > 0.f ? 1.f / l_i[rr] : 0.f;
    float* o = out + ((static_cast<long long>(b) * T_ + t) * Hq + kvh * G + g) * dh;
#pragma unroll
    for (int c = 0; c < DL; ++c)
      if (lane + 32 * c < dh) o[lane + 32 * c] = acc[rr][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const void* pos, const void* starts, const void* slopes, int B, int T_,
               int S, int Hq, int Hkv, int dh, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long rows = static_cast<long long>(T_) * (Hq / Hkv);
  dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), Hkv, B);
  flash_kernel<D><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<const int*>(pos), static_cast<const int*>(starts),
      static_cast<const float*>(slopes), T_, S, Hq, Hkv, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // query rows a block: 4 warps x 16
constexpr float kLog2e = 1.4426950408889634f;

// keys a K/V tile: 64, and 32 at width 256 (half the score registers)
template <int D>
__host__ __device__ constexpr int tc_keys() {
  return D <= 128 ? 64 : 32;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of row r in a tile of rows D bf16 wide,
// chunks XOR-swizzled by the row's low three bits
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (2 * D) + ((c ^ (r & 7)) << 4));
}

template <int D>
constexpr int tc_smem_bytes() {
  return (kTcRows + 4 * tc_keys<D>()) * 2 * D;  // Q, then K[2] and V[2]
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ pos, const int* __restrict__ starts,
                    const float* __restrict__ slopes, int B, int T_, int S, int Hq, int Hkv,
                    int dh, float scale, float scale_log2, int causal, int row_blocks) {
  constexpr int kKeys = tc_keys<D>();
  constexpr int kNt = kKeys / 8;      // 8-key score tiles a K/V tile
  constexpr int kKc = kKeys / 16;     // 16-key chunks (P's A fragments)
  constexpr bool kQRegs = D <= 128;   // Q fragments held in registers
  constexpr int kChunks = D / 8;      // 16-byte chunks a tile row
  const int chunks = dh / 8;          // of them, the ones the row has (the rest are zero)
  constexpr int kTile = kKeys * 2 * D;
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sq = smem_u32(smem_tc);
  const uint32_t sk = sq + kTcRows * 2 * D;  // K[buf] = sk + buf * kTile
  const uint32_t sv = sk + 2 * kTile;        // V[buf] = sv + buf * kTile

  // row blocks in descending order: the ones with the most causal tiles first
  const int bh = blockIdx.x % (B * Hkv);
  const int rb = row_blocks - 1 - static_cast<int>(blockIdx.x / (B * Hkv));
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int G = Hq / Hkv;
  const long long rows_total = static_cast<long long>(T_) * G;
  const long long r0 = static_cast<long long>(rb) * kTcRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos != nullptr ? pos[b] : 0;
  const int st = starts != nullptr ? starts[b] : 0;

  for (int i = tid; i < kTcRows * kChunks; i += 128) {
    const int r = i / kChunks, c = i % kChunks;
    const long long gr = r0 + r;
    const bool ok = gr < rows_total && c < chunks;
    const long long t = ok ? gr / G : 0, g = ok ? gr % G : 0;
    const long long row = (static_cast<long long>(b) * T_ + t) * Hq + kvh * G + g;
    cp_async16(sq + swz<D>(r, c), q + row * dh + 8 * (ok ? c : 0), ok);
  }
  cp_async_commit();

  // key columns any row of this block may need, as kKeys-key tiles
  const long long r_last = min(r0 + kTcRows, rows_total) - 1;
  const int col_hi = causal ? min(p + static_cast<int>(r_last / G), S - 1) : S - 1;
  const int lo = causal ? max(st, 0) : 0;
  const int j_first = lo / kKeys;
  const int n_tiles = col_hi >= lo ? col_hi / kKeys - j_first + 1 : 0;

  auto load_kv = [&](int tile, int buf) {
    const int j0 = (j_first + tile) * kKeys;
    for (int i = tid; i < kKeys * kChunks; i += 128) {
      const int r = i / kChunks, c = i % kChunks;
      const int col = j0 + r;
      const bool ok = col < S && c < chunks;
      const long long off =
          ((static_cast<long long>(b) * S + (ok ? col : 0)) * Hkv + kvh) * dh + 8 * (ok ? c : 0);
      cp_async16(sk + buf * kTile + swz<D>(r, c), k + off, ok);
      cp_async16(sv + buf * kTile + swz<D>(r, c), v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as mma A fragments, one per 16 columns of D:
  // held in registers, or (width 256) read from shared memory at each tile
  const int q_row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
  uint32_t qa[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(sq + swz<D>(q_row, 2 * kk + lane / 16), qa[kk]);
  }

  // this thread's rows: ra (accumulator rows lane / 4) and ra + 8
  const long long ra = r0 + warp * 16 + lane / 4;
  const int hi_a = causal ? min(p + static_cast<int>(ra / G), S - 1) : S - 1;
  const int hi_b = causal ? min(p + static_cast<int>((ra + 8) / G), S - 1) : S - 1;
  // their ALiBi slopes (natural-log units: with slopes the scores are
  // scaled and biased before the exponent, which then takes log2(e))
  const bool alibi = slopes != nullptr;
  const float slope_a = alibi ? slopes[kvh * G + static_cast<int>(ra % G)] : 0.f;
  const float slope_b = alibi ? slopes[kvh * G + static_cast<int>((ra + 8) % G)] : 0.f;
  const float mul = alibi ? kLog2e : scale_log2;
  // the warp's smallest and largest last column
  const long long wr0 = r0 + warp * 16;
  const int w_hi_min = causal ? min(p + static_cast<int>(wr0 / G), S - 1) : S - 1;
  const int w_hi_max = causal ? min(p + static_cast<int>((wr0 + 15) / G), S - 1) : S - 1;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = (j_first + it) * kKeys;
    if (j0 <= w_hi_max) {  // some row of this warp sees a key of this tile
      const uint32_t kb = sk + (it & 1) * kTile, vb = sv + (it & 1) * kTile;
      float s[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // S = Q K^T: B fragments of key tiles 2 np and 2 np + 1 by one ldmatrix
      auto qk = [&](int kk, const uint32_t (&qf)[4]) {
#pragma unroll
        for (int np = 0; np < kKc; ++np) {
          uint32_t kf[4];
          ldsm_x4(kb + swz<D>(16 * np + (lane % 8) + 8 * (lane / 16), 2 * kk + (lane / 8) % 2),
                  kf);
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      };
      if constexpr (kQRegs) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) qk(kk, qa[kk]);
      } else {
        // (a rolled loop: its addresses are not hoisted into registers)
#pragma unroll 1
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qf[4];
          ldsm_x4(sq + swz<D>(q_row, 2 * kk + lane / 16), qf);
          qk(kk, qf);
        }
      }
      if (alibi) {  // s = s * scale + m_h * column
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float col = static_cast<float>(j0 + 8 * nt + 2 * (lane % 4) + e);
            s[nt][e] = __fadd_rn(__fmul_rn(s[nt][e], scale), __fmul_rn(slope_a, col));
            s[nt][2 + e] = __fadd_rn(__fmul_rn(s[nt][2 + e], scale), __fmul_rn(slope_b, col));
          }
        }
      }
      if (j0 + kKeys - 1 > w_hi_min || j0 < lo) {  // some column is out of some row's band
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j0 + 8 * nt + 2 * (lane % 4) + e;
            if (col < lo || col > hi_a) s[nt][e] = -INFINITY;
            if (col < lo || col > hi_b) s[nt][2 + e] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row with no valid key so far keeps m = -inf; its p are exp2(-inf) = 0
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a * mul;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b * mul;
      const float alpha_a = exp2f(m_a * mul - base_a);  // 0 on the first tile
      const float alpha_b = exp2f(m_b * mul - base_b);
      m_a = mn_a;
      m_b = mn_b;
      // P as the A fragments of the 16-key chunks: chunk kc is score tiles
      // 2 kc (registers 0, 1) and 2 kc + 1 (2, 3), rows lane / 4 and + 8
      uint32_t pa[kKc][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const float p0 = exp2f(fmaf(s[nt][0], mul, -base_a));
        const float p1 = exp2f(fmaf(s[nt][1], mul, -base_a));
        const float p2 = exp2f(fmaf(s[nt][2], mul, -base_b));
        const float p3 = exp2f(fmaf(s[nt][3], mul, -base_b));
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        pa[nt / 2][2 * (nt % 2)] = pack_bf16(p0, p1);
        pa[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * alpha_a + sum_a;  // this thread's part of the row sum
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= alpha_a;
        o[dt][1] *= alpha_a;
        o[dt][2] *= alpha_b;
        o[dt][3] *= alpha_b;
      }
      // O += P V: B fragments of d tiles 2 dp and 2 dp + 1 by one ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldsm_x4_trans(vb + swz<D>(16 * kc + (lane % 8) + 8 * ((lane / 8) % 2),
                                    2 * dp + lane / 16),
                        vf);
          mma_bf16(o[2 * dp], pa[kc], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa[kc], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // before the next load overwrites this buffer
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long gr = ra + 8 * h;
    if (gr >= rows_total) continue;
    const float l = h == 0 ? l_a : l_b;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long long t = gr / G, g = gr % G;
    __nv_bfloat16* dst = out + ((static_cast<long long>(b) * T_ + t) * Hq + kvh * G + g) * dh;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (dt < chunks)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt + 2 * (lane % 4)) =
            __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, const void* pos,
              const void* starts, const void* slopes, int B, int T_, int S, int Hq, int Hkv,
              int dh, float scale, int causal, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  const long long rows = static_cast<long long>(T_) * (Hq / Hkv);
  const int row_blocks = static_cast<int>((rows + kTcRows - 1) / kTcRows);
  const long long blocks = static_cast<long long>(row_blocks) * B * Hkv;
  flash_tc_kernel<D><<<static_cast<unsigned>(blocks), 128, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(pos), static_cast<const int*>(starts),
      static_cast<const float*>(slopes), B, T_, S, Hq, Hkv, dh, scale, scale * kLog2e, causal,
      row_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const void* pos,
           const void* starts, const void* slopes, int B, int T_, int S, int Hq, int Hkv,
           int dh, float scale, int causal, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_tc<D>(q, k, v, out, pos, starts, slopes, B, T_, S, Hq, Hkv, dh,
                                scale, causal, s)
                 : launch_f32<D>(q, k, v, out, pos, starts, slopes, B, T_, S, Hq, Hkv, dh,
                                 scale, causal, s);
}

}  // namespace

// pos, starts: int32 [B] or null (zeros); slopes: f32 [Hq] ALiBi slopes or
// null. is_bf16: 0 f32 (CUDA cores), 1 bf16 (tensor cores; q, k, v 16-byte
// aligned, D a multiple of 8). D <= 256: the kernel of compute width 64
// serves D <= 64, that of 128 D <= 128, that of 256 the rest.
ASQ_EXPORT int asq_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, const void* pos, const void* starts,
                                   const void* slopes, int B, int T_, int S, int Hq,
                                   int Hkv, int D, float scale, int causal, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || T_ == 0) return 0;
  if (D < 1 || D > 256 || (is_bf16 && D % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<64>(q, k, v, out, pos, starts, slopes, B, T_, S, Hq, Hkv, D, scale, causal,
                      is_bf16, s);
  if (D <= 128)
    return launch<128>(q, k, v, out, pos, starts, slopes, B, T_, S, Hq, Hkv, D, scale, causal,
                       is_bf16, s);
  return launch<256>(q, k, v, out, pos, starts, slopes, B, T_, S, Hq, Hkv, D, scale, causal,
                     is_bf16, s);
}
