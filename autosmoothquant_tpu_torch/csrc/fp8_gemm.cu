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
// Hopper fp8 is native, so this file is the fp8 path for every M.
//
// What bounds it on an H100: at the main path's shapes (K 2048 / 5632, N
// 2048-11264, M 1-512) the weight bytes. At M = 128 a projection carries
// 1.1-5.9 GFLOP (0.5-3 us at the 1,979 TFLOP/s fp8 peak) but 4.2-23.1 MB of
// weights (1.3-6.9 us at 3.35 TB/s): a weight stream that needs the tensor
// cores only to keep up, read once, by enough SMs at once, with enough bytes
// in flight.
//
// Four routes, chosen by the wrapper from the shape (kernels/fp8.py uses
// kernels/gemm.py:route; never after a failure):
//  - M <= 8 (decode), K % 16 == 0 and 16-byte aligned bases: "gemv",
//    asq_fp8_gemv, the GEMV of asq_gemv.cuh (a block owns 16 weight rows,
//    its warps split K, the bytes stream through a cp.async ring,
//    x is read and converted once a block). Each fp8 pair becomes an f16
//    pair (cvt.rn.f16x2.e4m3x2 / e5m2x2: exact) and mma.sync.m16n8k16 f16
//    takes the weights as A and the <= 8 rows of x as B, accumulating in
//    f32 as the tensor-core route's wgmma does; the warps' partial sums
//    are added in a fixed order.
//  - M <= 8 otherwise (ragged K, an offset view): "gemv_ragged", one warp
//    per output column, a lane taking every 32nd value with fmaf; a warp
//    shuffle reduces. A product of two fp8 values is exact in f32.
//  - M > 8, K % 16 == 0 and both bases 16-byte aligned (what TMA takes):
//    asq_fp8_gemm_tc, the tensor-core route. A block covers BM = 64 or 128
//    rows (4 or 8 consumer warps of 16 rows, so each weight tile is read
//    once for all of M <= 128) by BN = 64 columns, and walks K in 128-byte
//    steps. One producer warp keeps a ring of 3 stages (x 128x128 + w 64x128
//    bytes = 24 KB a stage) filled with TMA (cp.async.bulk.tensor + mbarrier,
//    128-byte swizzle, zero fill past the edges). The consumer warpgroups
//    (one per 64 rows) convert each w tile to f16 once, into shared memory
//    in wgmma's K-major swizzled layout (cvt.rn.f16x2.e4m3x2 / e5m2x2:
//    exact, every fp8 value is an f16); each warp loads its x fragments with
//    ldmatrix and converts them in registers; wgmma.mma_async m64n64k16 f16
//    (A from registers, B from shared memory) accumulates in f32. Two
//    blocks fit on an SM (105 KB of shared memory each). Shapes with fewer
//    output tiles than SMs split K; the partial sums go to an f32 workspace
//    and a second small pass adds them in a fixed order before the
//    epilogue.
//  - M > 8 otherwise (ragged K such as 70, or an offset view): 64x64
//    CUDA-core tiles, K converted to f32 in shared memory.
//
// Why f16 and not fp8 wgmma: Hopper's fp8 wgmma keeps only about
// 14 bits of its running sum (DeepSeek-V3 technical report, section 3.3).
// Even with its partial sums added into f32 registers after every k32 step,
// its error on the H100 did not shrink with K, and the 2-layer fp8 models'
// card-vs-CPU logits broke their limits. f16 operands hold every fp8 value
// exactly, and the f16 tensor cores accumulate in f32. The route stays a
// weight stream at the main path's shapes.
//
// ldmatrix gives a lane bytes 4t..4t+3 (t = lane % 4) of a 16-byte row
// chunk of x, while the f16 fragments hold K positions {2t, 2t+1} and
// {2t+8, 2t+9}: position 2t + e carries k = 4t + e and 8 + 2t + e carries
// k = 4t + 2 + e. The f16 copy of w is written in the same order, so the
// products pair as in the plain sum.
//
// The epilogue is asq_store (asq_common.cuh) on each f32 sum, so given the
// same accumulator the output has the plain version's bits.

#include <cuda_fp8.h>

#include "asq_common.cuh"
#include "asq_gemv.cuh"
#include "asq_tma.cuh"

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

// two fp8 (byte 0 first) as an f16x2 register (byte 0 in the low half)
template <__nv_fp8_interpretation_t F>
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v), F);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// ---------------------------------------------------------------------------
// M <= 8: GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvMaxM = 8;

// "gemv": one 64-byte K step of the lane's 16 bytes of weight rows g and
// g + 8 and of x row g, as four m16n8k16 f16 products, one per word: the
// word's bytes 0-1 fill A's a0 / a1 (rows g / g + 8, K 2t, 2t + 1) and B's
// b0 (x row g, K 2t, 2t + 1), bytes 2-3 fill a2 / a3 and b1 (K 2t + 8,
// 2t + 9), so every weight value meets its x value
template <__nv_fp8_interpretation_t F>
struct Fp8Gemv {
  using Acc = float;
  __device__ static void step(float (&acc)[4], const uint4& w0, const uint4& w1, const uint4& x) {
    const uint32_t a[4] = {w0.x, w0.y, w0.z, w0.w}, b[4] = {w1.x, w1.y, w1.z, w1.w};
    const uint32_t c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gemv_mma(acc, fp8x2_to_f16x2<F>(a[j] & 0xffffu), fp8x2_to_f16x2<F>(b[j] & 0xffffu),
               fp8x2_to_f16x2<F>(a[j] >> 16), fp8x2_to_f16x2<F>(b[j] >> 16),
               fp8x2_to_f16x2<F>(c[j] & 0xffffu), fp8x2_to_f16x2<F>(c[j] >> 16));
  }
  __device__ static float value(float acc) { return acc; }
};

constexpr int kRaggedWarps = 8;

// "gemv_ragged": one warp per output column n; all M (<= 8) rows at once
template <__nv_fp8_interpretation_t F>
__global__ void __launch_bounds__(kRaggedWarps * 32)
    gemv_ragged_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                       int M, int N, int K, AsqEpilogue e) {
  const int n = blockIdx.x * kRaggedWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const uint8_t* wr = w + static_cast<size_t>(n) * K;
  float acc[kGemvMaxM];
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) acc[m] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float wv = fp8_to_float<F>(wr[k]);
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m)
      if (m < M)
        acc[m] = fmaf(fp8_to_float<F>(x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) {
    if (m < M) {
      const float total = asq_warp_sum(acc[m]);
      if (lane == m) asq_store(e, m, n, N, total);
    }
  }
}

// ---------------------------------------------------------------------------
// M > 8, shapes TMA cannot take: CUDA-core tiles
// ---------------------------------------------------------------------------

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
    const int blocks = (N + kRaggedWarps - 1) / kRaggedWarps;
    gemv_ragged_kernel<F><<<blocks, kRaggedWarps * 32, 0, s>>>(x, w, M, N, K, e);
  } else {
    const bool al4 = (K % 4 == 0) && (align % 4 == 0);
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_tiled_kernel<F><<<grid, 256, 0, s>>>(x, w, M, N, K, al4, e);
  }
}

// ---------------------------------------------------------------------------
// M > 8, TMA-shaped: f16 tensor cores fed from fp8 tiles
// ---------------------------------------------------------------------------

constexpr int kTcBN = 64;      // output columns a block
constexpr int kTcBK = 128;     // K bytes a stage: one 128-byte swizzle row
constexpr int kTcStages = 3;

// d += A[64 x 16] * B[64 x 16]^T: A from registers (f16, each warp 16 rows
// as mma.m16n8k16's A fragment), B f16 K-major in shared memory
__device__ __forceinline__ void wgmma_f16_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// grid (N / 64, M / BM, split); 4 WG consumer warps of 16 rows (BM = 64 WG)
// and one producer warp. Split z takes K tiles [z * per, (z + 1) * per);
// with ws != null it writes its f32 sums to ws[z] instead of the epilogue.
template <__nv_fp8_interpretation_t F, int WG>
__global__ void __launch_bounds__(WG * 128 + 32)
    gemm_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, int M, int N, int k_tiles,
                   int per, float* __restrict__ ws, AsqEpilogue e) {
  constexpr int kBMtc = 64 * WG;
  constexpr int kABytes = kBMtc * kTcBK, kBBytes = kTcBN * kTcBK;
  constexpr int kStage = kABytes + kBBytes;
  constexpr int kWf16 = kTcBN * kTcBK * 2;  // the w tile in f16
  extern __shared__ uint8_t smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t wf0 = tiles + kTcStages * kStage;                // f16 copy b at wf0 + b kWf16
  const uint32_t full0 = wf0 + 2 * kWf16;                         // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kTcStages;

  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * kBMtc, split = blockIdx.z;
  const int kt0 = split * per;
  const int nk = max(0, min(k_tiles, kt0 + per) - kt0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG * 4);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages) mbar_wait(empty0 + 8 * s, ((i / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, kStage);
        const int k = (kt0 + i) * kTcBK;
        tma_load_2d(tiles + s * kStage, &map_x, k, m0, full0 + 8 * s);
        tma_load_2d(tiles + s * kStage + kABytes, &map_w, k, n0, full0 + 8 * s);
      }
    }
    return;
  }

  // this warp's 16 rows of its warpgroup's 64: ldmatrix row addresses of
  // the two x matrices of a 16-byte chunk (matrices 2, 3: the next chunk)
  const int wg = warp / 4;
  const int xr = 64 * wg + 16 * (warp % 4) + (lane % 8) + 8 * ((lane / 8) % 2);
  const int xc = lane / 16;
  float acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kTcStages;
    mbar_wait(full0 + 8 * s, (i / kTcStages) & 1);
    const uint32_t xt = tiles + s * kStage, wt = xt + kABytes, wf = wf0 + (i & 1) * kWf16;
    // the w tile to f16 once for all warps, in the x fragments' K order, as
    // wgmma's 128-byte-swizzled K-major layout (two 64-deep halves of 64
    // rows x 128 bytes): the 16 fp8 of chunk j (words t = 0..3) become f16
    // chunk 2j (k 4t, 4t + 1) and 2j + 1 (k 4t + 2, 4t + 3) of half j / 4.
    // Double-buffered: a warp converting tile i + 1 has passed the barrier
    // every warp reaches after its wgmma on tile i - 1 completed
    for (int q = threadIdx.x; q < kTcBN * (kTcBK / 16); q += WG * 128) {
      const int n = q / (kTcBK / 16), j = q % (kTcBK / 16);
      const uint4 v = lds128(sw128(wt, n, j));
      const uint32_t half = wf + (j / 4) * (kTcBN * 128);
      sts128(sw128(half, n, 2 * (j % 4)), fp8x2_to_f16x2<F>(v.x & 0xffffu),
             fp8x2_to_f16x2<F>(v.y & 0xffffu), fp8x2_to_f16x2<F>(v.z & 0xffffu),
             fp8x2_to_f16x2<F>(v.w & 0xffffu));
      sts128(sw128(half, n, 2 * (j % 4) + 1), fp8x2_to_f16x2<F>(v.x >> 16),
             fp8x2_to_f16x2<F>(v.y >> 16), fp8x2_to_f16x2<F>(v.z >> 16),
             fp8x2_to_f16x2<F>(v.w >> 16));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync 1, %0;" ::"n"(WG * 128) : "memory");   // consumers only
    // this warp's x fragments of the 8 16-deep K steps, converted in registers
    uint32_t a[kTcBK / 16][4];
#pragma unroll
    for (int j = 0; j < kTcBK / 16; j += 2) {
      uint32_t xa[4];
      ldsm_x4(sw128(xt, xr, j + xc), xa);  // rows g / g + 8 of chunks j, j + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[j + h][0] = fp8x2_to_f16x2<F>(xa[2 * h] & 0xffffu);
        a[j + h][1] = fp8x2_to_f16x2<F>(xa[2 * h + 1] & 0xffffu);
        a[j + h][2] = fp8x2_to_f16x2<F>(xa[2 * h] >> 16);
        a[j + h][3] = fp8x2_to_f16x2<F>(xa[2 * h + 1] >> 16);
      }
    }
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < kTcBK / 16; ++j)
      wgmma_f16_rs(acc, a[j], sw128_desc(wf + (j / 4) * (kTcBN * 128) + 32 * (j % 4)));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // The epilogue goes through shared memory (the stage ring, free once every
  // consumer is past its last tile): one runtime loop with coalesced stores
  // and a single asq_store, where 32 unrolled ones per thread would let the
  // compiler copy the epilogue once per combination of its branches.
  // Accumulator layout of m64nN: acc[4 c + 2 h + q] sits at row 16 w +
  // lane / 4 + 8 h of the warpgroup's 64 (w: the warp in it), column
  // 8 c + 2 (lane % 4) + q.
  constexpr int kLd = kTcBN + 1;  // padded row: conflict-light writes
  float* const ep = reinterpret_cast<float*>(smem_raw + (tiles - smem_u32(smem_raw)));
  asm volatile("bar.sync 1, %0;" ::"n"(WG * 128) : "memory");
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int c = 0; c < kTcBN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ep[(r0 + 8 * h) * kLd + 8 * c + 2 * (lane % 4) + q] = acc[4 * c + 2 * h + q];
  asm volatile("bar.sync 1, %0;" ::"n"(WG * 128) : "memory");
  for (int i = threadIdx.x; i < kBMtc * kTcBN; i += WG * 128) {
    const int row = m0 + i / kTcBN, col = n0 + i % kTcBN;
    if (row >= M || col >= N) continue;
    const float v = ep[(i / kTcBN) * kLd + i % kTcBN];
    if (ws != nullptr) {
      ws[(static_cast<size_t>(split) * M + row) * N + col] = v;
    } else {
      asq_store(e, row, col, N, v);
    }
  }
}

// out = epilogue(sum over splits of ws[s]), the splits added in order
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                         AsqEpilogue e) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  float v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
  asq_store(e, static_cast<int>(i / N), static_cast<int>(i % N), N, v);
}

template <__nv_fp8_interpretation_t F, int WG>
int launch_tc(const void* x, const void* w, int M, int N, int K, int split, float* ws,
              const AsqEpilogue& e, cudaStream_t s) {
  constexpr int kBMtc = 64 * WG;
  constexpr int smem =
      kTcStages * (kBMtc + kTcBN) * kTcBK + 2 * kTcBN * kTcBK * 2 + 16 * kTcStages + 1024;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, M, K, kBMtc) || !make_map(&map_w, w, N, K, kTcBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_tc_kernel<F, WG>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int k_tiles = (K + kTcBK - 1) / kTcBK;
  const int per = (k_tiles + split - 1) / split;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kBMtc - 1) / kBMtc, split);
  kernel<<<grid, WG * 128 + 32, smem, s>>>(map_x, map_w, M, N, k_tiles, per,
                                           split > 1 ? ws : nullptr, e);
  if (split > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(ws, split, M,
                                                                                 N, e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <__nv_fp8_interpretation_t F>
int launch_tc_fmt(const void* x, const void* w, int M, int N, int K, int split, float* ws,
                  const AsqEpilogue& e, cudaStream_t s) {
  return M <= 64 ? launch_tc<F, 1>(x, w, M, N, K, split, ws, e, s)
                 : launch_tc<F, 2>(x, w, M, N, K, split, ws, e, s);
}

}  // namespace

// x [M, K] fp8, w_t [N, K] fp8 (fmt 0: e4m3fn, 1: e5m2), row_scale
// (rs_stride 0: one value, 1: [M]; null: 1), col_scale (cs_stride 0: one
// value, 1: [N]; null: 1), bias [N] f32 or null, out [M, N] (out_kind 0: f32,
// 1: bf16). The ragged GEMV for M <= 8, CUDA-core tiles above.
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

// The "gemv" route: arguments as asq_fp8_gemm, plus blocks (of 16 weight
// rows, kernels/gemm.py:gemv_blocks; they must cover N). Needs M <= 8,
// K % 16 == 0 and 16-byte aligned x and w_t.
ASQ_EXPORT int asq_fp8_gemv(const void* x, const void* w_t, const void* row_scale,
                            int rs_stride, const void* col_scale, int cs_stride,
                            const void* bias, void* out, int M, int N, int K, int fmt,
                            int out_kind, int blocks, void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride,
                static_cast<const float*>(bias), ASQ_ACT_NONE, out_kind, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_gemv_mma<Fp8Gemv<__NV_E4M3>>(x, w_t, M, N, K, blocks, e, s)
                  : launch_gemv_mma<Fp8Gemv<__NV_E5M2>>(x, w_t, M, N, K, blocks, e, s);
}

// The expert-indexed "gemv" route: arguments as asq_int8_expert_gemv, plus
// fmt (0 e4m3, 1 e5m2); out_kind f32 or bf16.
ASQ_EXPORT int asq_fp8_expert_gemv(const void* x, int x_estride, const void* w_t,
                                   const void* ids, int topk, int E, const void* row_scale,
                                   int rs_estride, int rs_stride, const void* col_scale,
                                   int cs_estride, int cs_stride, void* out, const void* w_b,
                                   const void* col_scale_b, void* out_b, int M, int N, int K,
                                   int fmt, int out_kind, int blocks, int slots,
                                   void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride, nullptr, ASQ_ACT_NONE,
                out_kind, out};
  AsqExperts ex{static_cast<const int64_t*>(ids), topk, E, x_estride, rs_estride, cs_estride,
                asq_out_bytes(out_kind), static_cast<const uint8_t*>(w_b),
                static_cast<const float*>(col_scale_b), out_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_gemv_mma_experts<Fp8Gemv<__NV_E4M3>>(x, w_t, M, N, K, blocks, slots,
                                                                 e, ex, s)
                  : launch_gemv_mma_experts<Fp8Gemv<__NV_E5M2>>(x, w_t, M, N, K, blocks, slots,
                                                                 e, ex, s);
}

// The tensor-core route: arguments as asq_fp8_gemm, plus split (K splits;
// ws holds split * M * N f32 where split > 1). Needs M > 8, K % 16 == 0 and
// 16-byte aligned x and w_t.
ASQ_EXPORT int asq_fp8_gemm_tc(const void* x, const void* w_t, const void* row_scale,
                               int rs_stride, const void* col_scale, int cs_stride,
                               const void* bias, void* out, int M, int N, int K, int fmt,
                               int out_kind, int split, void* ws, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t);
  if (M <= kGemvMaxM || K % 16 != 0 || align % 16 != 0 || split < 1 ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride,
                static_cast<const float*>(bias), ASQ_ACT_NONE, out_kind, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  return fmt == 0 ? launch_tc_fmt<__NV_E4M3>(x, w_t, M, N, K, split, wsp, e, s)
                  : launch_tc_fmt<__NV_E5M2>(x, w_t, M, N, K, split, wsp, e, s);
}
