// K5: W4A8 GEMM over split-K nibble-packed int4 weights, for M <= 64 rows.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/int4.py:_int4_kernel_a8
// (pallas_call in _int4_matmul_pallas, entry int4_matmul), with the per-token
// scale reduction JAX runs before it and the bias / activation / out-dtype
// epilogue it runs after it:
//
//   tok_scale[m] = max(absmax_k |x[m, k]|, 1e-8) / 127            (f32)
//                  or, where the caller gives it, tok_scale_in[m]
//   x_q[m, k]    = clamp(rint(x[m, k] / tok_scale[m]), -128, 127)  (int8)
//   acc[m, n]    = sum_g scale[n, g] * sum_{k in g} x_q[m, k] * (nib[n, k] - 8)
//   out[m, n]    = act(acc[m, n] * tok_scale[m] + bias[n])
//
// Layout (convert/from_jax.py): packed is [N, K'/2] uint8, byte r of column
// n holding row r in its low nibble and row r + K'/2 in its high nibble, each
// stored as q + 8; scales is [N, G] f32 with G = K' / group. K' >= K is the
// artifact's zero-padded depth; x is [M, K] with its true K, and the
// columns [K, K') count as zero (they quantize to 0 and add nothing), so no
// padded copy of x is made. tok_scale is a true f32 division (__fdiv_rn) and
// x_q rounds half to even: both are bit-exact with the JAX package on every
// route. Every group partial is an exact int32; the f32 sum over groups runs
// in another order than the plain version's. A given tok_scale_in (every
// route) is the per-token scale of the whole row when x is one rank's planes
// of a row-parallel product (models/common.py:int4_matmul_tp): the ranks then
// quantize against one scale, as the unsharded product does.
//
// What bounds it on an H100: bytes. Every packed byte (half the int8 weight
// bytes) and every group scale is read once: K'/2 * N + 4 * G * N bytes over
// 3.35 TB/s; at M = 64 the operations (2 * M * N * K', 1,979 TOP/s int8)
// stay below that.
//
// Three routes, chosen by the wrapper from the shape (kernels/int4.py:route):
//  - "gemv", M <= 4 for f32 x and M <= 2 for bf16 (M * K' <= 64 KB; past
//    those M every block's own quantize costs more than the tiles route's
//    quantize launch): one launch, a kernel for each row count (a template,
//    so each runs straight-line code). A block of 8
//    warps owns 8 * cpw output columns (cpw columns a warp, sized so the grid
//    fills the SMs about twice and a warp's columns fit in its 8 staged
//    slots). Each lane first issues asynchronous copies (cp.async) of its
//    16-byte chunks of the warp's packed columns into shared memory, so the
//    weight stream from device memory overlaps the quantize (loads into
//    registers would not: the quantize's barriers wait for them); chunks
//    past 8 (wide K) are prefetched into L2 with one bulk prefetch
//    (cp.async.bulk.prefetch.L2). The block then takes the absmax of its
//    rows over K' (zero past K; a max is the same in any order, so every
//    block gets the same bits), keeping x in registers, and quantizes the
//    rows once into shared memory (x_q [M, K']): a product with the rounded
//    reciprocal of tok_scale, and the true division wherever that product
//    lies within 2^-14 of a rounding tie, so x_q has the division's bits.
//    Each warp then takes its columns: for each 16-byte chunk a lane splits
//    each word into its low and high nibble planes, turns offset binary
//    into signed bytes (__vsub4), and takes __dp4a against the two matching
//    16-byte x_q chunks from shared memory. A 16-row chunk lies inside one
//    group, so its integer partial is exact; it is scaled by the group's
//    scale and summed in f32. A warp shuffle reduces, and asq_store applies
//    tok_scale, bias and activation. Every block reads x (M * K elements)
//    from L2 itself; nothing else is written but the output.
//  - "tc", 9 <= M <= 64 with group % 32 == 0, K'/2 a multiple of the group
//    and 16-byte aligned packed rows: the int8 tensor cores.
//    quant_rows_kernel quantizes x into a scratch x_q
//    (JAX too runs the absmax outside its kernel). Then a block of 4 warps
//    covers all <= 64 rows by 64 columns and walks K'/2 in stages of 128
//    packed bytes, through a 3-stage cp.async ring holding the packed tile,
//    the matching x_q columns of both halves, and the scale of each 32-byte
//    step. A 2 x 2 warp grid takes 32 rows x 32 columns each. The B fragment
//    of mma.sync.m16n8k32 (4 consecutive K bytes of one column) is one packed
//    word, so both halves' signed fragments come from it in registers with
//    __vsub4, and no unpacked copy of the weights is made. A fragments come
//    by ldmatrix. Each 32-byte step lies inside one group: two int32
//    partials (low and high half) collect the group exactly and go into the
//    f32 accumulator with its scale at the group's end. Where the output has
//    fewer 64-column tiles than SMs, K is split: each split writes f32
//    partials to a workspace, and a second pass adds them in a fixed order
//    (no atomics: the result does not depend on scheduling) before the
//    epilogue. The epilogue stages the tile through shared memory into one
//    asq_store loop.
//  - "tiles", every other M <= 64 shape: quant_rows_kernel, then one warp per
//    output column and up to 8 rows per pass (blockIdx.y walks M by 8), x_q
//    read from global memory; where K'/2 or the group is not a multiple of 16
//    a byte-wise loop serves.

#include "asq_common.cuh"
#include "asq_tma.cuh"

namespace {

// offset-binary nibbles of four packed bytes as four signed bytes: the low
// nibbles (rows r) or the high nibbles (rows r + K'/2)
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) {
  return __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
}
__device__ __forceinline__ uint32_t nib_hi(uint32_t w) {
  return __vsub4((w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

// ---------------------------------------------------------------------------
// per-token quantize (the "tc" and "tiles" routes)
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;

// ts_in (null: the row's own absmax) gives each row's scale
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, int K, int Kp, const float* __restrict__ ts_in,
                      int8_t* __restrict__ xq, float* __restrict__ ts) {
  __shared__ float warp_max[kQuantThreads / 32];
  const T* row = x + static_cast<size_t>(blockIdx.x) * K;
  float scale;
  if (ts_in != nullptr) {
    scale = ts_in[blockIdx.x];
  } else {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += kQuantThreads)
      amax = fmaxf(amax, fabsf(asq_to_float(row[k])));
    amax = asq_warp_max(amax);
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = 0.f;
#pragma unroll
    for (int w = 0; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
    scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  }
  if (threadIdx.x == 0) ts[blockIdx.x] = scale;
  int8_t* qrow = xq + static_cast<size_t>(blockIdx.x) * Kp;
  for (int k = threadIdx.x; k < Kp; k += kQuantThreads)
    qrow[k] = k < K ? asq_quant_int8(__fdiv_rn(asq_to_float(row[k]), scale)) : 0;
}

template <typename T>
int launch_quant(const void* x, int M, int K, int Kp, const float* ts_in, int8_t* xq,
                 float* ts, cudaStream_t s) {
  quant_rows_kernel<T><<<M, kQuantThreads, 0, s>>>(static_cast<const T*>(x), K,
                                                   Kp, ts_in, xq, ts);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "tiles": one warp per column, 8 rows a pass
// ---------------------------------------------------------------------------

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
        lo[i] = static_cast<int>(nib_lo(words[i]));
        hi[i] = static_cast<int>(nib_hi(words[i]));
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

// ---------------------------------------------------------------------------
// "gemv": M <= 4, quantize fused, one launch
// ---------------------------------------------------------------------------

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvMaxM = 4;  // the most rows kernels/int4.py routes here
constexpr int kGemvPre = 8;   // 16-byte weight chunks a lane stages before the quantize
constexpr int kGemvHold = 8;  // float4s of x a thread keeps between absmax and quantize
constexpr int kGemvMaxXq = 64 * 1024;  // x_q bytes a block may keep (kernels/int4.py)
constexpr int kSms = 132;              // streaming multiprocessors of an H100 SXM

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// x[k .. k + 3] of one row as f32, zero past K; vec: one vector load (K % 4
// == 0 and an aligned base)
template <typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ row, int k, int K, bool vec) {
  if (vec) return k < K ? ld4(row + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < K ? asq_to_float(row[k + i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(asq_quant_int8(a))) |
         (static_cast<uint32_t>(static_cast<uint8_t>(asq_quant_int8(b))) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(asq_quant_int8(c))) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(asq_quant_int8(d))) << 24);
}

// the true division, out of line: quant4 takes it only near rounding ties
__device__ __noinline__ uint32_t quant4_div(float4 v, float s) {
  return pack4(__fdiv_rn(v.x, s), __fdiv_rn(v.y, s), __fdiv_rn(v.z, s), __fdiv_rn(v.w, s));
}

// asq_quant_int8(__fdiv_rn(v, s)) of four values bit for bit, with r = 1 / s
// (rounded): |v / s| <= 128, so v * r lies within 3 * 128 * 2^-24 < 2^-14 of
// the correctly rounded quotient and rounds to the same integer unless it
// lies within 2^-14 of a half-integer; there the true division decides
__device__ __forceinline__ float tie_distance(float y) {
  return fabsf(y - floorf(y) - 0.5f);
}

__device__ __forceinline__ uint32_t quant4(float4 v, float s, float r) {
  const float a = __fmul_rn(v.x, r), b = __fmul_rn(v.y, r);
  const float c = __fmul_rn(v.z, r), d = __fmul_rn(v.w, r);
  const float near = fminf(fminf(tie_distance(a), tie_distance(b)),
                           fminf(tie_distance(c), tie_distance(d)));
  if (near < 6.103515625e-05f) return quant4_div(v, s);
  return pack4(a, b, c, d);
}

// acc[m] += the two exact 16-byte partials of packed chunk pv (bytes c ..
// c + 15: rows c.. in the low nibbles, K2 + c.. in the high ones) against
// the MR x_q rows in shared memory, each times its group's scale
template <int MR>
__device__ __forceinline__ void gemv_chunk(const int8_t* xq, int Kp, int K2, int c, uint4 pv,
                                           float sl, float sh, float (&acc)[MR]) {
  const uint32_t words[4] = {pv.x, pv.y, pv.z, pv.w};
  int lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = static_cast<int>(nib_lo(words[i]));
    hi[i] = static_cast<int>(nib_hi(words[i]));
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int8_t* xr = xq + static_cast<size_t>(m) * Kp;
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

// column n's sums: a warp reduction per row, then one store per row from
// lane m (a single asq_store call site); acc is reset
template <int MR>
__device__ __forceinline__ void gemv_finish(const AsqEpilogue& e, int n, int N, int lane,
                                            float (&acc)[MR]) {
  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float total = asq_warp_sum(acc[m]);
    if (lane == m) mine = total;
    acc[m] = 0.f;
  }
  if (lane < MR) asq_store(e, lane, n, N, mine);
}

// MR = M rows, a template, so each row count runs straight-line code. Three
// blocks an SM (<= 80 registers) keep every block of the main path's
// shapes resident at once: the grid is one wave
template <typename T, int MR>
__global__ void __launch_bounds__(kGemvThreads, 3)
    w4a8_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, int N, int K, int K2, int G, int group,
                     uint32_t gmul, int cpw, int pre, bool vec16, bool xvec,
                     const float* __restrict__ ts_in, AsqEpilogue e) {
  // dynamic shared memory: x_q [MR, K'], then per warp `pre` slots of 32
  // lanes, a 16-byte packed chunk each
  extern __shared__ __align__(16) uint8_t gemv_smem[];
  int8_t* const xq = reinterpret_cast<int8_t*>(gemv_smem);
  __shared__ float part[kGemvWarps][MR];
  __shared__ float ts[MR];
  constexpr int kHold = kGemvHold / MR;  // float4s of x kept a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Kp = 2 * K2;
  const int n0 = (blockIdx.x * kGemvWarps + warp) * cpw;
  const int ncols = max(0, min(cpw, N - n0));
  const int slot0 = warp * pre * 32 + lane;  // the lane's slot t is slot0 + 32 t
  const uint4* const wst = reinterpret_cast<const uint4*>(gemv_smem + (MR * Kp + 15) / 16 * 16);

  // 1. the weights first: a lane takes 16-byte chunks lane, lane + 32, ...
  // of each of the warp's columns, `per` slots a column. The first `pre`
  // slots are asynchronous copies into shared memory, issued now, so their
  // device-memory latency overlaps the quantize below (loads into registers
  // would not: the quantize's barriers wait for them); their scales, a few
  // bytes, are loads whose latency the absmax's own loads cover. The rest
  // (wide K) are prefetched into L2 and read in the column loop.
  // (the group of packed byte c is __umulhi(c, gmul), gmul = ceil(2^32 /
  // group): exact for c < 2^32 / group, and here c < K' <= 64 Ki)
  const int chunks = K2 / 16;
  const int per = max(1, (chunks + 31) / 32);
  const int total = vec16 ? ncols * per : 0;
  const int staged = min(pre, total);
  float wsl[kGemvPre], wsh[kGemvPre];
  {
    int j = 0, slot = 0;  // t = j * per + slot
#pragma unroll
    for (int t = 0; t < kGemvPre; ++t) {
      const int c = 16 * (lane + 32 * slot);
      if (t < staged && c < K2) {
        const size_t n = n0 + j;
        cp_async16(smem_u32(wst + slot0 + 32 * t), packed + n * K2 + c);
        wsl[t] = __ldg(scales + n * G + __umulhi(c, gmul));
        wsh[t] = __ldg(scales + n * G + __umulhi(K2 + c, gmul));
      }
      if (++slot == per) {
        slot = 0;
        ++j;
      }
    }
  }
  cp_async_commit();
  if (lane == 0 && total > staged) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                     packed + static_cast<size_t>(n0) * K2),
                 "r"(ncols * K2)
                 : "memory");
  }

  // 2. per-token absmax over K' (zero past K), then tok_scale by a true
  // division. A thread takes float4s 4 (tid + i * threads) of each row and
  // keeps the first kHold of them for the quantize; every row's loads go
  // out before any row's reduction.
  const int nch = (Kp + 4 * kGemvThreads - 1) / (4 * kGemvThreads);
  float4 xv[MR][kHold];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < kHold; ++i)
      if (i < nch)
        xv[m][i] = load4(x + static_cast<size_t>(m) * K, 4 * (threadIdx.x + i * kGemvThreads), K,
                         xvec);
  float amax[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    amax[m] = 0.f;
#pragma unroll
    for (int i = 0; i < kHold; ++i)
      if (i < nch) amax[m] = fmaxf(amax[m], abs_max4(xv[m][i]));
    for (int i = kHold; i < nch; ++i)
      amax[m] = fmaxf(amax[m], abs_max4(load4(x + static_cast<size_t>(m) * K,
                                              4 * (threadIdx.x + i * kGemvThreads), K, xvec)));
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    amax[m] = asq_warp_max(amax[m]);
    if (lane == 0) part[warp][m] = amax[m];
  }
  __syncthreads();
  if (threadIdx.x < MR) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) a = fmaxf(a, part[w][threadIdx.x]);
    ts[threadIdx.x] = ts_in != nullptr ? ts_in[threadIdx.x] : __fdiv_rn(fmaxf(a, 1e-8f), 127.f);
  }
  __syncthreads();

  // 3. x_q [MR, K'] into shared memory (K' % 4 == 0)
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const T* row = x + static_cast<size_t>(m) * K;
    const float s = ts[m], r = __frcp_rn(s);
    uint32_t* dst = reinterpret_cast<uint32_t*>(xq + static_cast<size_t>(m) * Kp);
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      const int k = 4 * (threadIdx.x + i * kGemvThreads);
      if (i < nch && k < Kp) dst[k / 4] = quant4(xv[m][i], s, r);
    }
    for (int i = kHold; i < nch; ++i) {
      const int k = 4 * (threadIdx.x + i * kGemvThreads);
      if (k < Kp) dst[k / 4] = quant4(load4(row, k, K, xvec), s, r);
    }
  }
  __syncthreads();

  // 4. each warp takes its columns against x_q: the staged slots (each
  // lane reads only the slots it copied, so its own wait suffices), then
  // the slots past them from L2; a column's last slot ends it
  AsqEpilogue el = e;
  el.rs = ts;  // tok_scale, from shared memory
  el.rs_stride = 1;
  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;
  cp_async_wait<0>();
  if (vec16) {
    int j = 0, slot = 0;  // t = j * per + slot
#pragma unroll
    for (int t = 0; t < kGemvPre; ++t) {
      if (t < staged) {
        const int c = 16 * (lane + 32 * slot);
        if (c < K2) gemv_chunk<MR>(xq, Kp, K2, c, wst[slot0 + 32 * t], wsl[t], wsh[t], acc);
        if (slot == per - 1) gemv_finish<MR>(el, n0 + j, N, lane, acc);
      }
      if (++slot == per) {
        slot = 0;
        ++j;
      }
    }
    for (int t = staged; t < total; ++t) {
      const int j = t / per, slot = t - j * per, ch = lane + 32 * slot;
      if (ch < chunks) {
        const size_t n = n0 + j;
        gemv_chunk<MR>(xq, Kp, K2, 16 * ch,
                       __ldg(reinterpret_cast<const uint4*>(packed + n * K2) + ch),
                       __ldg(scales + n * G + 16 * ch / group),
                       __ldg(scales + n * G + (K2 + 16 * ch) / group), acc);
      }
      if (slot == per - 1) gemv_finish<MR>(el, n0 + j, N, lane, acc);
    }
  } else {
    for (int j = 0; j < ncols; ++j) {
      const int n = n0 + j;
      const uint8_t* pr = packed + static_cast<size_t>(n) * K2;
      const float* sr = scales + static_cast<size_t>(n) * G;
      for (int c = lane; c < K2; c += 32) {
        const int b = pr[c];
        const int lo = (b & 15) - 8, hi = (b >> 4) - 8;
        const float sl = sr[c / group];
        const float sh = sr[(K2 + c) / group];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int8_t* xr = xq + static_cast<size_t>(m) * Kp;
          acc[m] = fmaf(__int2float_rn(static_cast<int>(xr[c]) * lo), sl, acc[m]);
          acc[m] = fmaf(__int2float_rn(static_cast<int>(xr[K2 + c]) * hi), sh, acc[m]);
        }
      }
      gemv_finish<MR>(el, n, N, lane, acc);
    }
  }
}

template <typename T, int MR>
int launch_gemv(const void* x, const void* packed, const void* scales, int N, int K, int K2,
                int G, bool vec16, const float* ts_in, const AsqEpilogue& e, cudaStream_t s) {
  const int Kp = 2 * K2;
  const int group = Kp / G;
  const uint32_t gmul = static_cast<uint32_t>(((1ull << 32) + group - 1) / group);
  const int xq_bytes = (MR * Kp + 15) / 16 * 16;
  // columns a warp: the grid fills the SMs about twice, and where it can, a
  // warp's columns fit in its kGemvPre staged slots a lane
  const int per = max(1, (K2 / 16 + 31) / 32);
  const int cpw = max(1, min(N / (kGemvWarps * 2 * kSms), kGemvPre / per));
  const int pre = vec16 ? min(kGemvPre, cpw * per) : 0;
  const int smem = xq_bytes + pre * kGemvThreads * 16;  // <= 64 KB + 32 KB
  const int warps = (N + cpw - 1) / cpw;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool xvec = K % 4 == 0 && xa % (4 * sizeof(T)) == 0;
  auto kernel = w4a8_gemv_kernel<T, MR>;
  // once: room for the largest x_q the route takes and every slot, so no
  // launch pays for the call
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemvMaxXq + kGemvPre * kGemvThreads * 16);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  kernel<<<(warps + kGemvWarps - 1) / kGemvWarps, kGemvThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), N, K, K2, G, group, gmul, cpw, pre, vec16, xvec, ts_in,
      e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemv_rows(const void* x, const void* packed, const void* scales, int M, int N, int K,
                     int K2, int G, bool vec16, const float* ts_in, const AsqEpilogue& e,
                     cudaStream_t s) {
  switch (M) {
    case 1: return launch_gemv<T, 1>(x, packed, scales, N, K, K2, G, vec16, ts_in, e, s);
    case 2: return launch_gemv<T, 2>(x, packed, scales, N, K, K2, G, vec16, ts_in, e, s);
    case 3: return launch_gemv<T, 3>(x, packed, scales, N, K, K2, G, vec16, ts_in, e, s);
    default: return launch_gemv<T, 4>(x, packed, scales, N, K, K2, G, vec16, ts_in, e, s);
  }
}

// ---------------------------------------------------------------------------
// "tc": int8 tensor cores (mma.sync m16n8k32 s8.s8 -> s32)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps: 2 x 2, each 32 rows x 32 columns
constexpr int kTcBN = 64;        // output columns a block (all <= 64 rows)
constexpr int kTcBK = 128;       // packed bytes (positions of K'/2) a stage
constexpr int kTcStages = 3;
constexpr int kTcLd = kTcBK + 16;  // row pitch: conflict-free fragment reads
constexpr int kTcTile = 64 * kTcLd;
// a stage: packed [64][128], x_q low half [64][128], x_q high half
// [64][128], then the scales of its 32-byte steps [64 columns][4 low, 4 high]
constexpr int kTcStage = 3 * kTcTile + kTcBN * 8 * 4;
constexpr int kTcSmem = kTcStages * kTcStage;

// d += a[16 x 32] * b[32 x 8], s8 in, exact s32 sum
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (N / 64, split); split z takes stages [z * per, (z + 1) * per) of K'/2
// and, with ws != null, writes its f32 partials to ws[z] instead of the
// epilogue
__global__ void __launch_bounds__(kTcThreads)
    w4a8_tc_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, int M, int N, int K2, int G, int group,
                   int k_steps, int per, float* __restrict__ ws, AsqEpilogue e) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const uint32_t base = smem_u32(tc_smem);
  const int n0 = blockIdx.x * kTcBN, split = blockIdx.y;
  const int ks0 = split * per;
  const int nk = max(0, min(k_steps, ks0 + per) - ks0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);  // the warp's first row, column
  const int g = lane / 4, t = lane % 4;
  const size_t Kp = 2 * static_cast<size_t>(K2);

  // stage i of this split into ring slot i % kTcStages. Rows past M and
  // columns past N are not loaded: they only reach outputs that are not
  // stored. Chunks past K'/2 are not loaded and not read.
  auto load_stage = [&](int i) {
    const int c0 = (ks0 + i) * kTcBK;
    const int chunks = min(kTcBK, K2 - c0) / 16;
    const uint32_t st = base + (i % kTcStages) * kTcStage;
    for (int idx = tid; idx < 64 * (kTcBK / 16); idx += kTcThreads) {
      const int r = idx / (kTcBK / 16), ch = idx % (kTcBK / 16);
      if (ch >= chunks) continue;
      const uint32_t off = r * kTcLd + ch * 16;
      if (n0 + r < N) cp_async16(st + off, packed + static_cast<size_t>(n0 + r) * K2 + c0 + ch * 16);
      if (r < M) {
        const int8_t* xr = xq + r * Kp + c0 + ch * 16;
        cp_async16(st + kTcTile + off, xr);
        cp_async16(st + 2 * kTcTile + off, xr + K2);
      }
    }
    for (int idx = tid; idx < kTcBN * 8; idx += kTcThreads) {
      const int r = idx / 8, j = idx % 8, step = j % 4;
      if (32 * step >= K2 - c0 || n0 + r >= N) continue;
      const int k = (j < 4 ? 0 : K2) + c0 + 32 * step;
      cp_async4(st + 3 * kTcTile + 4 * idx, scales + static_cast<size_t>(n0 + r) * G + k / group);
    }
  };

  int plo[2][4][4], phi[2][4][4];  // int32 partials of the current group, low / high half
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        plo[mt][nt][r] = 0;
        phi[mt][nt][r] = 0;
        acc[mt][nt][r] = 0.f;
      }
  const bool mt_on[2] = {wm < M, wm + 16 < M};

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage i landed for every thread; slot (i - 1) is free
    if (i + kTcStages - 1 < nk) load_stage(i + kTcStages - 1);
    cp_async_commit();
    const int slot = i % kTcStages;
    const uint32_t st = base + slot * kTcStage;
    const uint8_t* wt = tc_smem + slot * kTcStage;
    const float* sc = reinterpret_cast<const float*>(wt + 3 * kTcTile);
    const int c0 = (ks0 + i) * kTcBK;
    const int steps = min(kTcBK, K2 - c0) / 32;
#pragma unroll
    for (int j = 0; j < kTcBK / 32; ++j) {
      if (j >= steps) break;
      // B of column tile nt: n = g, K bytes 4t.. and 16 + 4t..: one packed
      // word each, which holds both halves' fragments
      uint32_t blo[4][2], bhi[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* wr = wt + (wn + nt * 8 + g) * kTcLd + 32 * j + 4 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + 16);
        blo[nt][0] = nib_lo(w0);
        blo[nt][1] = nib_lo(w1);
        bhi[nt][0] = nib_hi(w0);
        bhi[nt][1] = nib_hi(w1);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!mt_on[mt]) continue;
        // A of rows wm + 16 mt ..: ldmatrix quarters (rows 0-7 | 8-15) x (K 0-15 | 16-31)
        const uint32_t xa =
            st + kTcTile + (wm + mt * 16 + lane % 16) * kTcLd + 32 * j + (lane / 16) * 16;
        uint32_t alo[4], ahi[4];
        ldsm_x4(xa, alo);
        ldsm_x4(xa + kTcTile, ahi);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_s8(plo[mt][nt], alo, blo[nt][0], blo[nt][1]);
          mma_s8(phi[mt][nt], ahi, bhi[nt][0], bhi[nt][1]);
        }
      }
      // a group ends (or the split does): its exact partials into f32
      if ((c0 + 32 * j + 32) % group == 0 || (i == nk - 1 && j == steps - 1)) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = wn + nt * 8 + 2 * t + q;
            const float sl = sc[col * 8 + j], sh = sc[col * 8 + 4 + j];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 2 * h + q;
                acc[mt][nt][r] = fmaf(__int2float_rn(plo[mt][nt][r]), sl, acc[mt][nt][r]);
                acc[mt][nt][r] = fmaf(__int2float_rn(phi[mt][nt][r]), sh, acc[mt][nt][r]);
                plo[mt][nt][r] = 0;
                phi[mt][nt][r] = 0;
              }
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The epilogue goes through shared memory (the ring, free now): one
  // runtime loop with a single asq_store. Accumulator layout of m16n8:
  // element 2 h + q sits at row g + 8 h, column 2 t + q.
  constexpr int kEpLd = kTcBN + 1;
  float* const ep = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ep[(wm + mt * 16 + g + 8 * (r / 2)) * kEpLd + wn + nt * 8 + 2 * t + r % 2] =
            acc[mt][nt][r];
  __syncthreads();
  for (int idx = tid; idx < 64 * kTcBN; idx += kTcThreads) {
    const int row = idx / kTcBN, col = idx % kTcBN;
    if (row >= M || n0 + col >= N) continue;
    const float v = ep[row * kEpLd + col];
    if (ws != nullptr) {
      ws[(static_cast<size_t>(split) * M + row) * N + n0 + col] = v;
    } else {
      asq_store(e, row, n0 + col, N, v);
    }
  }
}

// out = epilogue(ws[0] + ws[1] + ...), added in split order
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N, AsqEpilogue e) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  float v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
  asq_store(e, static_cast<int>(i / N), static_cast<int>(i % N), N, v);
}

}  // namespace

// x [M, K] f32 (x_is_bf16 = 0) or bf16 (1); packed [N, K2] uint8 (K' = 2*K2
// >= K); scales [N, G] f32 (group = K' / G); bias [N] f32 or null; act 0
// none, 1 relu, 2 silu; out [M, N] (out_kind 0: f32, 1: bf16); xq_scratch
// [M, K'] int8 and ts_scratch [M] f32 are written (the quantized x and its
// per-token scales); tok_scale [M] f32 or null (each row's own absmax) gives
// the per-token scales. The "tiles" route.
ASQ_EXPORT int asq_int4_gemm(const void* x, int x_is_bf16, const void* packed,
                             const void* scales, const void* bias, const void* tok_scale,
                             void* out,
                             void* xq_scratch, void* ts_scratch, int M, int N,
                             int K, int K2, int G, int act, int out_kind,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kp = 2 * K2;
  const int group = Kp / G;
  const auto ts_in = static_cast<const float*>(tok_scale);
  auto xq = static_cast<int8_t*>(xq_scratch);
  auto ts = static_cast<float*>(ts_scratch);
  const int rc = x_is_bf16 ? launch_quant<__nv_bfloat16>(x, M, K, Kp, ts_in, xq, ts, s)
                           : launch_quant<float>(x, M, K, Kp, ts_in, xq, ts, s);
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

// The "gemv" route, one launch: arguments as asq_int4_gemm without the
// scratch buffers. Needs M <= 4, K' % 4 == 0 (x_q is written 4 bytes at a
// time) and M * K' <= 64 KB (x_q in shared memory).
ASQ_EXPORT int asq_int4_gemv(const void* x, int x_is_bf16, const void* packed,
                             const void* scales, const void* bias, const void* tok_scale,
                             void* out, int M, int N,
                             int K, int K2, int G, int act, int out_kind, void* stream) {
  if (M < 1 || M > kGemvMaxM || K2 % 2 != 0 || M * 2 * K2 > kGemvMaxXq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto ts_in = static_cast<const float*>(tok_scale);
  const int group = 2 * K2 / G;
  const bool vec16 = (K2 % 16 == 0) && (group % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(packed) % 16 == 0);
  AsqEpilogue e{nullptr, 1, nullptr, 0, static_cast<const float*>(bias), act, out_kind, out};
  return x_is_bf16
             ? launch_gemv_rows<__nv_bfloat16>(x, packed, scales, M, N, K, K2, G, vec16, ts_in, e,
                                               s)
             : launch_gemv_rows<float>(x, packed, scales, M, N, K, K2, G, vec16, ts_in, e, s);
}

// The "tc" route: arguments as asq_int4_gemm, plus split (K splits; ws holds
// split * M * N f32 where split > 1). Needs M <= 64, group % 32 == 0, K2 %
// group == 0 (a step's low and high halves end their groups together) and a
// 16-byte aligned packed.
ASQ_EXPORT int asq_int4_gemm_tc(const void* x, int x_is_bf16, const void* packed,
                                const void* scales, const void* bias, const void* tok_scale,
                                void* out,
                                void* xq_scratch, void* ts_scratch, int M, int N, int K, int K2,
                                int G, int act, int out_kind, int split, void* ws,
                                void* stream) {
  const int Kp = 2 * K2;
  const int group = Kp / G;
  const uintptr_t align = reinterpret_cast<uintptr_t>(packed) |
                          reinterpret_cast<uintptr_t>(xq_scratch);
  if (M < 1 || M > 64 || group % 32 != 0 || K2 % group != 0 || align % 16 != 0 ||
      split < 1 || (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto ts_in = static_cast<const float*>(tok_scale);
  auto xq = static_cast<int8_t*>(xq_scratch);
  auto ts = static_cast<float*>(ts_scratch);
  const int rc = x_is_bf16 ? launch_quant<__nv_bfloat16>(x, M, K, Kp, ts_in, xq, ts, s)
                           : launch_quant<float>(x, M, K, Kp, ts_in, xq, ts, s);
  if (rc != 0) return rc;
  AsqEpilogue e{ts, 1, nullptr, 0, static_cast<const float*>(bias), act, out_kind, out};
  const int k_steps = (K2 + kTcBK - 1) / kTcBK;
  const int per = (k_steps + split - 1) / split;
  float* wsp = split > 1 ? static_cast<float*>(ws) : nullptr;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(w4a8_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((N + kTcBN - 1) / kTcBN, split);
  w4a8_tc_kernel<<<grid, kTcThreads, kTcSmem, s>>>(xq, static_cast<const uint8_t*>(packed),
                                                    static_cast<const float*>(scales), M, N, K2,
                                                    G, group, k_steps, per, wsp, e);
  if (split > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(wsp, split, M,
                                                                                 N, e);
  }
  return static_cast<int>(cudaGetLastError());
}
