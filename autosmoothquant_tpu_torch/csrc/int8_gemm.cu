// K1: int8 x int8 -> int32 GEMM with the dequantizing epilogue fused in.
//
// Replaces the TPU kernel autosmoothquant_tpu/kernels/gemm.py:
// _int8_matmul_kernel (pallas_call in _int8_matmul_pallas, entry int8_matmul):
//
//   out[m, n] = act(acc[m, n] * row_scale[m] * col_scale[n] + bias[n])
//   acc       = sum_k x[m, k] * w_t[n, k]          (exact, int32)
//
// with out in f32, bf16 or int8 (round half to even, clamp to [-128, 127]),
// or out = acc itself in int32 (no scale, bias or activation: the partial
// of a row-parallel projection, which the ranks sum before the epilogue).
// x is [M, K] and w_t is [N, K], both K-contiguous (nn.Linear's layout); the
// JAX package's [K, N] weights are transposed once at load time.
//
// What bounds it on an H100: at decode (M = batch, 1..8) every weight byte is
// read once and used M times, so the time is the weight bytes over 3.35 TB/s.
// At prefill (M = B*T = 128-512) a projection carries 1.1-69 GOP (0.5-35 us
// at the 1,979 TOP/s int8 tensor-core peak) and 4-67 MB of weights (1.3-20
// us): a weight stream at M = 128 that needs the tensor cores to keep up,
// bound by the operations at M = 512.
//
// Four routes, chosen by the wrapper from the shape (kernels/gemm.py:route,
// never after a failure):
//  - M <= 8 (decode), K % 16 == 0 and 16-byte aligned bases: "gemv",
//    asq_int8_gemv, the GEMV of asq_gemv.cuh (a block owns 16 weight rows,
//    its warps split K, the bytes stream through a cp.async ring,
//    x is read once a block, and mma.sync.m16n8k32.s32.s8.s8 takes the
//    weights as A and the <= 8 rows of x as B); exact int32 sums.
//  - M <= 8 otherwise (ragged K, an offset view): "gemv_ragged", one warp
//    per output column, a lane taking every 32nd byte; a warp shuffle
//    reduces.
//  - M > 8, K % 16 == 0 and both bases 16-byte aligned (what TMA takes):
//    asq_int8_gemm_tc, the tensor-core route. A block covers BM = 64 or 128
//    rows (one or two consumer warpgroups, so each weight tile is read once
//    for all of M <= 128) by BN = 64 columns and walks K in 128-byte stages.
//    One producer warp keeps a ring of stages (x BM x 128 + w 64 x 128
//    bytes) filled with TMA (cp.async.bulk.tensor + mbarrier, 128-byte
//    swizzle, zero fill past M, N and K). Each stage is four
//    wgmma.mma_async m64n64k32 s32.s8.s8 steps with A and B both read from
//    shared-memory descriptors: int8 operands need no conversion, and both
//    are K-major as they lie in memory. One wgmma group stays in flight
//    while the next issues; a stage goes back to the producer once the
//    group that read it has retired. Shapes with fewer output tiles than
//    SMs split K: the int32 partial sums go to a workspace and a second
//    pass adds them (integer addition is exact, so the order does not
//    matter) before the epilogue.
//  - M > 8 otherwise (ragged K such as 70, or an offset view): 64x64 output
//    tiles, 64-byte K steps staged in shared memory, 256 threads each
//    holding a 4x4 block of int32 accumulators (__dp4a). Edges are masked
//    (zero-filled words), so no shape or alignment is refused.
//
// |acc| <= 128 * 127 * K stays below 2**31 for K < 132,000, so the int32 sum
// is exact on every route. The epilogue (asq_store, asq_common.cuh)
// multiplies in the JAX order (acc * row) * col, then adds the bias, with
// explicit round-to-nearest intrinsics: given the exact accumulator, the f32
// output equals the plain PyTorch version's bits.

#include "asq_common.cuh"
#include "asq_gemv.cuh"
#include "asq_tma.cuh"

namespace {

constexpr int kGemvMaxM = 8;

// "gemv": one 64-byte K step of the lane's 16 bytes of weight rows g and
// g + 8 and of x row g, as two m16n8k32 products: A fragment words a0 / a2
// (row g, K 4t.. / 16 + 4t..) and a1 / a3 (row g + 8), B words b0 / b1 (x
// row g, K 4t.. / 16 + 4t..) take bytes 0-3 / 4-7 of the lane's chunks,
// then bytes 8-11 / 12-15, so every weight byte meets its x byte
struct Int8Gemv {
  using Acc = int;
  __device__ static void step(int (&acc)[4], const uint4& w0, const uint4& w1, const uint4& x) {
    gemv_mma(acc, w0.x, w1.x, w0.y, w1.y, x.x, x.y);
    gemv_mma(acc, w0.z, w1.z, w0.w, w1.w, x.z, x.w);
  }
  __device__ static int value(int acc) { return acc; }
};

constexpr int kRaggedWarps = 8;

// "gemv_ragged": one warp per output column n; all M (<= 8) rows at once
__global__ void __launch_bounds__(kRaggedWarps * 32)
    gemv_ragged_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       int M, int N, int K, AsqEpilogue e) {
  const int n = blockIdx.x * kRaggedWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const int8_t* wr = w + static_cast<size_t>(n) * K;
  int acc[kGemvMaxM];
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) acc[m] = 0;
  for (int k = lane; k < K; k += 32) {
    const int wv = wr[k];
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m)
      if (m < M) acc[m] += static_cast<int>(x[static_cast<size_t>(m) * K + k]) * wv;
  }
#pragma unroll
  for (int m = 0; m < kGemvMaxM; ++m) {
    if (m < M) {
      const int total = asq_warp_sum_int(acc[m]);
      if (lane == m) asq_store(e, m, n, N, total);
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
      if (m < M && n < N) asq_store(e, m, n, N, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// M > 8, TMA-shaped: int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBN = 64;      // output columns a block
constexpr int kTcBK = 128;     // K bytes a stage: one 128-byte swizzle row
constexpr int kTcStages = 4;

// d += A[64 x 32] * B[64 x 32]^T, both int8, K-major in shared memory
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// grid (N / 64, M / BM, split); 4 WG consumer warps (BM = 64 WG) and one
// producer warp. Split z takes K tiles [z * per, (z + 1) * per); with
// ws != null it writes its int32 sums to ws[z] instead of the epilogue.
template <int WG>
__global__ void __launch_bounds__(WG * 128 + 32)
    gemm_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, int M, int N, int k_tiles,
                   int per, int* __restrict__ ws, AsqEpilogue e) {
  constexpr int kBMtc = 64 * WG;
  constexpr int kABytes = kBMtc * kTcBK, kBBytes = kTcBN * kTcBK;
  constexpr int kStage = kABytes + kBBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t full0 = tiles + kTcStages * kStage;              // full[s] = full0 + 8 s
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

  // warpgroup wg multiplies rows [64 wg, 64 wg + 64) of the x tile
  const int wg = warp / 4;
  int acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kTcStages;
    mbar_wait(full0 + 8 * s, (i / kTcStages) & 1);
    const uint32_t xt = tiles + s * kStage + wg * 64 * kTcBK, wt = tiles + s * kStage + kABytes;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < kTcBK / 32; ++j)
      wgmma_s8_ss(acc, sw128_desc(xt + 32 * j), sw128_desc(wt + 32 * j));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // tile i's group stays in flight; tile i - 1's has retired, and its
    // stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_regs(acc);
    __syncwarp();
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kTcStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(acc);

  // The epilogue goes through shared memory (the stage ring, free once every
  // consumer is past its last tile): one runtime loop with coalesced stores
  // and a single asq_store, where 32 unrolled ones per thread would let the
  // compiler copy the epilogue once per combination of its branches.
  // Accumulator layout of m64nN: acc[4 c + 2 h + q] sits at row 16 w +
  // lane / 4 + 8 h of the warpgroup's 64 (w: the warp in it), column
  // 8 c + 2 (lane % 4) + q.
  constexpr int kLd = kTcBN + 1;  // padded row: conflict-light writes
  int* const ep = reinterpret_cast<int*>(smem_raw + (tiles - smem_u32(smem_raw)));
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
    const int v = ep[(i / kTcBN) * kLd + i % kTcBN];
    if (ws != nullptr) {
      ws[(static_cast<size_t>(split) * M + row) * N + col] = v;
    } else {
      asq_store(e, row, col, N, v);
    }
  }
}

// out = epilogue(sum over splits of ws[s]); int32 addition is exact, so the
// result has the unsplit kernel's bits
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const int* __restrict__ ws, int splits, int M, int N,
                         AsqEpilogue e) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  int v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
  asq_store(e, static_cast<int>(i / N), static_cast<int>(i % N), N, v);
}

template <int WG>
int launch_tc(const void* x, const void* w, int M, int N, int K, int split, int* ws,
              const AsqEpilogue& e, cudaStream_t s) {
  constexpr int kBMtc = 64 * WG;
  constexpr int smem = kTcStages * (kBMtc + kTcBN) * kTcBK + 16 * kTcStages + 1024;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, M, K, kBMtc) || !make_map(&map_w, w, N, K, kTcBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_tc_kernel<WG>;
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

}  // namespace

// x [M, K] int8, w_t [N, K] int8, row_scale (rs_stride 0: one value, 1: [M];
// null: 1), col_scale (cs_stride 0: one value, 1: [N]; null: 1), bias [N] f32
// or null, out [M, N].
// act: 0 none, 1 relu, 2 silu; out_kind: 0 f32, 1 bf16, 2 int8, 3 int32 (the
// accumulator; scales, bias and act must be absent). The
// ragged GEMV for M <= 8, CUDA-core tiles above.
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
    const int blocks = (N + kRaggedWarps - 1) / kRaggedWarps;
    gemv_ragged_kernel<<<blocks, kRaggedWarps * 32, 0, s>>>(xp, wp, M, N, K, e);
  } else {
    const bool al4 = (K % 4 == 0) && (align % 4 == 0);
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_tiled_kernel<<<grid, 256, 0, s>>>(xp, wp, M, N, K, al4, e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The "gemv" route: arguments as asq_int8_gemm, plus blocks (of 16 weight
// rows, kernels/gemm.py:gemv_blocks; they must cover N). Needs M <= 8,
// K % 16 == 0 and 16-byte aligned x and w_t.
ASQ_EXPORT int asq_int8_gemv(const void* x, const void* w_t, const void* row_scale,
                             int rs_stride, const void* col_scale, int cs_stride,
                             const void* bias, void* out, int M, int N, int K, int act,
                             int out_kind, int blocks, void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride,
                static_cast<const float*>(bias), act, out_kind, out};
  return launch_gemv_mma<Int8Gemv>(x, w_t, M, N, K, blocks, e,
                                   static_cast<cudaStream_t>(stream));
}

// The expert-indexed "gemv" route (asq_gemv.cuh: gemv_mma_expert_kernel):
// for each expert that ids (int64 [M, topk], on the device) names, out[e] =
// epilogue(x_e @ w_t[e].T), zeros in out[e] of every other expert. x [M, K]
// for every expert (x_estride 0) or [E, M, K] (x_estride M * K); w_t [E, N,
// K]; row_scale + e * rs_estride (rs_stride 0: one value, 1: [M]; null: 1);
// col_scale + e * cs_estride (cs_stride 0: one value, 1: [N]; null: 1); out
// [E, M, N] of out_kind (no bias, no activation); w_b, col_scale_b and out_b,
// where w_b is not null, a second projection of w_t's shape on the same x
// and row scales, in the same launch (w1 and w3); blocks as asq_int8_gemv;
// slots = min(E, M * topk). Needs M <= 8, K % 16 == 0, E <= 64 and 16-byte
// aligned x and weights.
ASQ_EXPORT int asq_int8_expert_gemv(const void* x, int x_estride, const void* w_t,
                                    const void* ids, int topk, int E, const void* row_scale,
                                    int rs_estride, int rs_stride, const void* col_scale,
                                    int cs_estride, int cs_stride, void* out, const void* w_b,
                                    const void* col_scale_b, void* out_b, int M, int N, int K,
                                    int out_kind, int blocks, int slots, void* stream) {
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride, nullptr, ASQ_ACT_NONE,
                out_kind, out};
  AsqExperts ex{static_cast<const int64_t*>(ids), topk, E, x_estride, rs_estride, cs_estride,
                asq_out_bytes(out_kind), static_cast<const uint8_t*>(w_b),
                static_cast<const float*>(col_scale_b), out_b};
  return launch_gemv_mma_experts<Int8Gemv>(x, w_t, M, N, K, blocks, slots, e, ex,
                                           static_cast<cudaStream_t>(stream));
}

// The tensor-core route: arguments as asq_int8_gemm, plus split (K splits;
// ws holds split * M * N int32 where split > 1). Needs M > 8, K % 16 == 0
// and 16-byte aligned x and w_t.
ASQ_EXPORT int asq_int8_gemm_tc(const void* x, const void* w_t, const void* row_scale,
                                int rs_stride, const void* col_scale, int cs_stride,
                                const void* bias, void* out, int M, int N, int K, int act,
                                int out_kind, int split, void* ws, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_t);
  if (M <= kGemvMaxM || K % 16 != 0 || align % 16 != 0 || split < 1 ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AsqEpilogue e{static_cast<const float*>(row_scale), rs_stride,
                static_cast<const float*>(col_scale), cs_stride,
                static_cast<const float*>(bias), act, out_kind, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* wsp = static_cast<int*>(ws);
  return M <= 64 ? launch_tc<1>(x, w_t, M, N, K, split, wsp, e, s)
                 : launch_tc<2>(x, w_t, M, N, K, split, wsp, e, s);
}
