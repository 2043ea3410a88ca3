// The decode GEMV K1 (int8_gemm.cu) and K4 (fp8_gemm.cu) share, for
// M <= 8 rows of x [M, K] against the weight w [N, K] (bytes, K-contiguous):
//
//   acc[m, n] = sum_k x[m, k] * w[n, k],   out = asq_store(acc)
//
// What bounds it on an H100: the weight bytes, read once (N * K over 3.35
// TB/s), behind the launch and one device-memory round trip. The design
// keeps many bytes in flight, reads x once a block and leaves the products
// to the tensor cores:
//  - A block owns 16 consecutive weight rows, i.e. output columns, and its
//    8 warps split K into 64-byte steps, dealt out in turn (warp w takes
//    steps w, w + 8, ...), so the block's requests in flight are runs of
//    2 KB of each row (4 steps a warp). The weight copies carry the
//    L2::256B prefetch hint. The grid is one block per 16 weight rows
//    (kernels/gemm.py:gemv_blocks), up to 4 blocks an SM. On the H100,
//    8-row blocks (which spread the bytes more evenly over the SMs at
//    N = 2560) were slower at every main-path shape, and an 8-stage ring
//    (two blocks an SM) was no faster than 4 stages (PERF.md).
//  - Products on the tensor cores with the weights as the A operand ("swap
//    AB"): weight rows take the 16-row side of mma.sync m16n8, the M <= 8
//    rows of x the n8 side (rows past M are zero). Lane (g, t) = (lane / 4,
//    lane % 4) of a warp holds, each step, the 16 bytes at K offset 16 t of
//    weight rows g and g + 8 and of x row g. Op::step feeds them to the
//    tensor cores with the same K order on both sides (any order gives the
//    same sum of products), so no shuffle or shared layout is needed.
//  - The bytes come through a ring of 4 steps in shared memory, filled
//    with cp.async 16-byte copies: each lane copies its own three slots and
//    reads back only those, so its own cp.async.wait_group is all the
//    synchronisation the loop needs (no barrier waits on the stream), and a
//    lane keeps 4 steps in flight: all of them where K <= 2048 (past a
//    warp's last step the commit groups are empty). Rows past M or N and
//    bytes past K are zero-filled by the copy itself, which then reads
//    nothing.
//  - Each x byte is read once a block (by the one warp whose steps cover
//    it) and, in K4, converted once a block.
//  - The warps' partial sums (the m16n8 accumulator fragment: element
//    2 h + q of lane (g, t) is weight row g + 8 h, x row 2 t + q) meet in
//    shared memory and are added in warp order, a fixed order, so K4's f32
//    bits do not change from run to run; one asq_store per output, stores
//    coalesced along N, its scales and bias loaded before the loop. No
//    atomics, no workspace, no second pass.
#pragma once

#include "asq_common.cuh"
#include "asq_tma.cuh"

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvRows = 16;       // weight rows (output columns) a block
constexpr int kGemvStep = 64;       // K bytes a warp's step covers (4 lanes x 16)
constexpr int kGemvStages = 4;      // steps a lane keeps in flight
constexpr int kGemvSlot = kGemvThreads * 16;  // one 16-byte slot for every thread
constexpr int kGemvStageBytes = 3 * kGemvSlot;  // x row g, weight rows g and g + 8
constexpr int kGemvRingBytes = kGemvStages * kGemvStageBytes;  // 48 KB, dynamic

// d (m16n8, s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void gemv_mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d (m16n8, f32) += a (16 x 16 f16, row) * b (16 x 8 f16, col)
__device__ __forceinline__ void gemv_mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared with the L2::256B prefetch hint (the weight
// stream); zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_l2(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Op: Acc (the accumulator type), step(acc, w_g, w_g8, x_g) (one 64-byte
// K step: the lane's 16 bytes of weight rows g and g + 8 and of x row g
// into the tensor cores) and value(acc) (the sum as f32 for asq_store).
// Four blocks an SM (<= 64 registers, 53 KB of shared memory each).
template <class Op>
__global__ void __launch_bounds__(kGemvThreads, 4)
    gemv_mma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w, int M, int N,
                    int K, AsqEpilogue e) {
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) uint8_t gemv_ring[];
  __shared__ __align__(16) Acc red[kGemvWarps][32][4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kGemvRows;
  const int steps = (K + kGemvStep - 1) / kGemvStep;
  const int mine = (steps - warp + kGemvWarps - 1) / kGemvWarps;  // steps warp + 8 j
  const bool x_on = g < M, w0_on = n0 + g < N, w1_on = n0 + g + 8 < N;
  const uint8_t* const xr = x + static_cast<size_t>(x_on ? g : 0) * K;
  const uint8_t* const w0r = w + static_cast<size_t>(w0_on ? n0 + g : 0) * K;
  const uint8_t* const w1r = w + static_cast<size_t>(w1_on ? n0 + g + 8 : 0) * K;
  const uint32_t ring = smem_u32(gemv_ring) + threadIdx.x * 16;
  // this thread's output (m, n0 + r), r fastest, and its epilogue operands
  const int om = threadIdx.x / kGemvRows, orow = threadIdx.x % kGemvRows;
  const bool out_on = om < M && n0 + orow < N;
  const AsqOperands ops = out_on ? asq_operands(e, om, n0 + orow) : AsqOperands{};

  // step j of this warp into ring stage `slot`; one commit group a step
  // (empty past the warp's last step), so group i is step i
  auto issue = [&](int j, int slot) {
    if (j < mine) {
      const int k = (warp + kGemvWarps * j) * kGemvStep + 16 * t;
      const bool in = k < K;
      const int kk = in ? k : 0;
      const uint32_t st = ring + slot * kGemvStageBytes;
      cp_async16(st, xr + kk, in && x_on);
      cp_async16_l2(st + kGemvSlot, w0r + kk, in && w0_on);
      cp_async16_l2(st + 2 * kGemvSlot, w1r + kk, in && w1_on);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j + 1 < kGemvStages; ++j) issue(j, j);

  Acc acc[4] = {};
  for (int i = 0; i < mine; ++i) {
    // stage (i + 3) % 4 held step i - 1, which this lane has already read
    issue(i + kGemvStages - 1, (i + kGemvStages - 1) % kGemvStages);
    cp_async_wait<kGemvStages - 1>();  // step i has landed
    const uint32_t st = ring + (i % kGemvStages) * kGemvStageBytes;
    Op::step(acc, lds128(st + kGemvSlot), lds128(st + 2 * kGemvSlot), lds128(st));
  }
  cp_async_wait<0>();

#pragma unroll
  for (int c = 0; c < 4; ++c) red[warp][lane][c] = acc[c];
  __syncthreads();
  // weight row r of x row m sits in lane 4 (r % 8) + m / 2, element
  // 2 (r / 8) + m % 2 (8 x 16 outputs: one a thread at most)
  if (out_on) {
    const int src = 4 * (orow % 8) + om / 2, c = 2 * (orow / 8) + om % 2;
    Acc v = red[0][src][c];
#pragma unroll
    for (int q = 1; q < kGemvWarps; ++q) v += red[q][src][c];
    asq_store(e, ops, om, n0 + orow, N, Op::value(v));
  }
}

// The launch: M <= 8, K % 16 == 0 and 16-byte aligned x and w (each
// 16-byte copy then lies inside one row); blocks of 16 weight rows that
// cover all N.
template <class Op>
int launch_gemv_mma(const void* x, const void* w, int M, int N, int K, int blocks,
                    const AsqEpilogue& e, cudaStream_t s) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (M < 1 || M > 8 || K % 16 != 0 || align % 16 != 0 ||
      static_cast<long long>(blocks) * kGemvRows < N)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemv_mma_kernel<Op>;
  // once: room for the ring beside the static 4 KB, so no launch pays for
  // the call
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvRingBytes);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  kernel<<<blocks, kGemvThreads, kGemvRingBytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
