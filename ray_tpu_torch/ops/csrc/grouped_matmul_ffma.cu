// Grouped matrix products for Hopper (sm_90a) in fp32: the instantiation
// the wgmma pair (grouped_matmul.cu, bf16 operands) does not cover.
//
// Replaces jax's Pallas TPU library kernels megablox/gmm.py:gmm (pallas_call
// at gmm.py:526) and :tgmm (pallas_call at gmm.py:763) for fp32 operands,
// which ray_tpu/models/moe.py:_grouped_matmul passes them when the model
// computes in fp32 (MoEConfig.mixtral_8x7b(compute_dtype=float32)):
//
//   gmm   out[m, :] = lhs[m, :] @ rhs[g(m)]         lhs [M, K], rhs [E, K, N]
//         transpose_rhs: rhs [E, N, K] and out[m, :] = lhs[m, :] @ rhs[g(m)]^T
//   tgmm  out[g] = lhs[rows of g, :]^T @ grad[rows of g, :]
//                                  lhs [M, K], grad [M, N], out [E, K, N]
//
// the rows of group g being [off[g], off[g + 1]), off the exclusive prefix
// sum of group_sizes [E] (int32, on the device), clamped to [0, M] as the
// bf16 kernels clamp it.  tgmm reads lhs in its forward layout [M, K] (the
// caller's lhs_t [K, M] is a transposed view): the backward copies no
// activation.
//
// What bounds it on the H100: operations.  At the MoE training shapes
// (M = 16384, K = 4096, N = 14336, E = 8) each call is 2 M K N = 1.924e12
// flops, 28.7 ms at the 67 TFLOP/s fp32 peak outside the tensor cores
// (FFMA: fp32 stays fp32, no TF32 and no bf16 rounding of an operand),
// against 2.3 ms for its ~3.1 GB at 3.35 TB/s.  An SM issues four FFMA
// warp-instructions a clock and serves 128 bytes of shared memory a clock,
// so the products have to be fed from registers as far as they can:
//   - a block of 256 threads computes a 128 x 256 output tile, each thread
//     8 rows x 16 columns (128 fp32 accumulators): per depth step 6
//     LDS.128 (8 + 16 floats) feed 128 FFMA, 5.3 FFMA a float loaded
//     (the first design's 8 x 8 tiles: 4).  One product loop serves all
//     three kernels, over output-contiguous tiles [16][rows] and
//     [16][columns];
//   - tiles go from global to shared memory by cp.async 16-byte copies in
//     each operand's own layout (never through registers), 16 deep a
//     stage, 4 stages in flight (cp.async.commit_group / wait_group), one
//     barrier a stage.  Copies past M, K, N or a tgmm group's end read
//     zeros (src-size 0).  tgmm's operands (rows of lhs and grad) arrive
//     output-contiguous.  gmm's K-contiguous ones (lhs; rhs under
//     transpose_rhs) land as [rows][16 + 4] and are transposed once a
//     stage, one stage ahead of their products, into a swizzled [16][rows]
//     buffer (4 x 4 blocks, 4 float4 loads and 4 float4 stores each, free
//     of bank conflicts).  Reading K along a row of lhs in the product
//     loop instead (8 loads every 4 steps, 255 registers) ran 6% slower
//     without transpose_rhs and 2% faster with it;
//   - 96-168 KB of dynamic shared memory, one block of 8 warps an SM
//     (__launch_bounds__(256, 1): 227-249 registers, no spills);
//   - the group plan comes from shapes alone: every block reads the E
//     sizes and forms the offsets itself, so the host never waits for
//     routing.  gmm's blocks are runs (group, 128-row m-tile), a tile that
//     straddles a group boundary run once per group it touches, with that
//     group's rhs, storing that group's rows only (at most E extra runs in
//     each n-column), and runs of a pseudo-group E that write zeros to the
//     rows past the last group; tgmm's blocks are (K tile, N tile, group),
//     each summing its group's rows 16 at a time, the rows at or past the
//     group's end zero-filled in both operand tiles (a neighbour's inf must
//     not leak in as 0 * inf); a group without rows writes zeros.
// Measured (PERF.md): 61% (gmm) and 71% (tgmm) of the fp32 peak at the
// MoE training shapes; with the fragments' shared-memory loads taken out,
// tgmm still reached only 77%, so the FFMA stream itself, more than
// shared memory, sets the pace.
// Each output element is one FFMA chain over k = 0, 1, ..., K - 1 (over a
// group's rows in order, for tgmm), written once, without atomics or split
// K, so repeat calls give the same bits.
//
// Rounding points are megablox's at fp32: products and sums in fp32, the
// output fp32.  The plain versions (gmm_reference / tgmm_reference in
// ray_tpu_torch/ops/grouped_matmul.py) differ only in summation order and
// in where an FMA fuses a product.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 256;  // output tile
constexpr int BK = 16;             // reduction depth of a stage
constexpr int kStages = 4;         // stages in flight
constexpr int kLdk = BK + 4;       // a K-contiguous tile's padded row
constexpr int kMaxGroups = 64;

// floats of one stage's tiles: gmm's lhs [BM][kLdk]; rhs [BK][BN], or
// [BN][kLdk] with the transpose; tgmm's lhs rows [BK][BM], grad rows
// [BK][BN]
constexpr int kGmmA = BM * kLdk;
template <bool TRANS>
constexpr int kGmmB = TRANS ? BN * kLdk : BK * BN;
constexpr int kTgmmA = BK * BM, kTgmmB = BK * BN;
// dynamic shared memory of a block: gmm's stages and its two transposed
// buffers of each K-contiguous operand (120 KB, 168 KB with TRANS); tgmm's
// stages (96 KB)
template <bool TRANS>
constexpr int kGmmSmem =
    (kStages * (kGmmA + kGmmB<TRANS>) + 2 * (kTgmmA + (TRANS ? kTgmmB : 0))) * 4;
constexpr int kTgmmSmem = kStages * (kTgmmA + kTgmmB) * 4;
static_assert(kGmmSmem<true> <= 232448, "over the 227 KB a block may take");

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- common
// the group offsets, shared: sizes read by E threads at once, then
// off[0..E] = their exclusive prefix sums clamped to [0, M] (thread 0).
// Ends with a barrier.
__device__ __forceinline__ void group_offsets(const int* sizes, int E, int M, int* off) {
  const int t = threadIdx.x;
  if (t < E) off[t + 1] = sizes[t];
  __syncthreads();
  if (t == 0) {
    int acc = 0;
    off[0] = 0;
    for (int g = 0; g < E; ++g) {
      acc = min(acc + max(min(off[g + 1], M), 0), M);
      off[g + 1] = acc;
    }
  }
  __syncthreads();
}

// the thread's place (ty, tx) in the block's 16 x 16 grid: a quarter warp
// is 4 thread-rows x 2 thread-columns, a warp 2 x 2 quarters, the block 2
// x 4 warps.  So a quarter warp's float4 loads fetch 4 distinct ones of a
// and 2 of b (8 of b, 1 of a in 1 x 8 quarters: 4-5% slower).  The
// thread's outputs are rows ty * 8 + i (i < 8) and columns tx * 4 + 64 *
// (j / 4) + j % 4 (j < 16) of the tile.
__device__ __forceinline__ int thread_row() {
  const int w = threadIdx.x >> 5, q = (threadIdx.x >> 3) & 3, p = threadIdx.x & 7;
  return (w >> 2) * 8 + (q >> 1) * 4 + (p >> 1);
}
__device__ __forceinline__ int thread_col() {
  const int w = threadIdx.x >> 5, q = (threadIdx.x >> 3) & 3, p = threadIdx.x & 7;
  return (w & 3) * 4 + (q & 1) * 2 + (p & 1);
}

__device__ __forceinline__ void ld4(float* r, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

// offset of column `col` in row k of a swizzled output-contiguous tile:
// its float4 chunk XOR 2 * (k / 4), so that the transposing float4 stores
// below (4 depth rows x 2 chunks a quarter warp) hit 8 bank groups, while a
// quarter warp's reads of 8 consecutive chunks of one row stay distinct
static_assert(BK == 16, "the swizzle takes 4 groups of 4 depth rows");
template <bool SWIZZLE>
__device__ __forceinline__ int col_at(int k, int col) {
  return SWIZZLE ? (((col >> 2) ^ ((k >> 2) << 1)) << 2) | (col & 3) : col;
}

// A K-contiguous stage tile [ROWS][kLdk] as an output-contiguous, swizzled
// [BK][ROWS] one: each 4 x 4 block (rows 4b.., depth 4c..) read as 4
// float4s and written as 4, transposed in registers
template <int ROWS>
__device__ __forceinline__ void transpose(float* dst, const float* src) {
#pragma unroll
  for (int q = 0; q < (ROWS * BK / 16 + kThreads - 1) / kThreads; ++q) {
    const int blk = threadIdx.x + q * kThreads;
    if (blk >= ROWS * BK / 16) break;
    const int b = blk >> 2, c = blk & 3;
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(v[i], src + (4 * b + i) * kLdk + 4 * c);
#pragma unroll
    for (int d = 0; d < 4; ++d)
      *reinterpret_cast<float4*>(dst + (4 * c + d) * ROWS + col_at<true>(4 * c + d, 4 * b)) =
          make_float4(v[0][d], v[1][d], v[2][d], v[3][d]);
  }
}

// One stage's products from output-contiguous tiles a [BK][BM] and b
// [BK][BN] (each swizzled or not): per depth step the thread's 8 rows of a
// as 2 float4s and its 16 columns of b as 4, then 128 FFMA.  Every
// accumulator takes its depth steps in order.
template <bool SWA, bool SWB>
__device__ __forceinline__ void products(float (&acc)[8][16], const float* a_tile,
                                         const float* b_tile) {
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[8], b[16];
    ld4(a, a_tile + k * BM + col_at<SWA>(k, ty * 8));
    ld4(a + 4, a_tile + k * BM + col_at<SWA>(k, ty * 8 + 4));
#pragma unroll
    for (int h = 0; h < 4; ++h) ld4(b + 4 * h, b_tile + k * BN + col_at<SWB>(k, h * 64 + tx * 4));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc rows within [lo, hi) (tile-relative) and columns < N - n0 to a
// row-major [*, N] output at (row0, n0)
__device__ __forceinline__ void store_rows(float* out, int64_t N, const float (&acc)[8][16],
                                           int row0, int n0, int lo, int hi) {
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r < lo || r >= hi) continue;
    float* o = out + (int64_t)(row0 + r) * N + n0;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (n0 + h * 64 + tx * 4 < N)
        *reinterpret_cast<float4*>(o + h * 64 + tx * 4) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// ---------------------------------------------------------------- gmm
// One stage's copies: lhs rows m0.. (columns k0..k0 + 15) into as [BM][kLdk];
// rhs[g] rows k0.. (columns n0..) into bs [BK][BN], or with TRANS rhs[g]
// rows n0.. (columns k0..) into bs [BN][kLdk].  Past M, K or N: zeros.
template <bool TRANS>
__device__ __forceinline__ void gmm_copy(float* as, float* bs, const float* lhs, const float* w,
                                         int M, int K, int N, int m0, int n0, int k0) {
  constexpr int kRowK = BK / 4, kRowN = BN / 4;  // 16-byte copies a row
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < BM * kRowK / kThreads; ++q) {
    const int c = t + q * kThreads, r = c / kRowK, k = (c % kRowK) * 4;
    const bool ok = m0 + r < M && k0 + k < K;
    cp_async16(as + r * kLdk + k, ok ? lhs + (int64_t)(m0 + r) * K + k0 + k : lhs, ok);
  }
#pragma unroll
  for (int q = 0; q < BK * BN / 4 / kThreads; ++q) {
    const int c = t + q * kThreads;
    if (TRANS) {
      const int r = c / kRowK, k = (c % kRowK) * 4;
      const bool ok = n0 + r < N && k0 + k < K;
      cp_async16(bs + r * kLdk + k, ok ? w + (int64_t)(n0 + r) * K + k0 + k : w, ok);
    } else {
      const int r = c / kRowN, n = (c % kRowN) * 4;
      const bool ok = k0 + r < K && n0 + n < N;
      cp_async16(bs + r * BN + n, ok ? w + (int64_t)(k0 + r) * N + n0 + n : w, ok);
    }
  }
}

// The K-contiguous tiles of a landed stage (lhs's; rhs's with TRANS) into
// the output-contiguous buffers `at` and `bt`
template <bool TRANS>
__device__ __forceinline__ void gmm_transpose(float* at, float* bt, const float* as,
                                              const float* bs) {
  transpose<BM>(at, as);
  if (TRANS) transpose<BN>(bt, bs);
}

// Block b: run b % (tiles_m + E) (group g, m-tile) and n-tile b / (tiles_m
// + E), m-tiles fastest.  Runs list, for
// g = 0..E - 1 and then the rows past the last group (g = E), each m-tile
// the group's rows touch; there are at most tiles_m + E, and blocks past
// the last run return.  Stage kt's K-contiguous tiles are transposed into
// buffer kt % 2 one stage ahead of its products, between the same barriers
// that order the copies.
template <bool TRANS>
__global__ void __launch_bounds__(kThreads, 1)
gmm_ffma_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                const int* __restrict__ sizes, float* __restrict__ out, int M, int K, int N,
                int E) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int off[kMaxGroups + 1];
  __shared__ int run[2];
  const int runs_n = (M + BM - 1) / BM + E, nt = blockIdx.x / runs_n;
  int j = blockIdx.x % runs_n;
  group_offsets(sizes, E, M, off);
  if (threadIdx.x == 0) {
    run[0] = -1;
    for (int g = 0; g <= E; ++g) {
      const int lo = off[g], hi = g < E ? off[g + 1] : M;
      const int runs = hi > lo ? (hi - 1) / BM - lo / BM + 1 : 0;
      if (j < runs) {
        run[0] = g;
        run[1] = (lo / BM + j) * BM;
        break;
      }
      j -= runs;
    }
  }
  __syncthreads();
  const int g = run[0], m0 = run[1], n0 = nt * BN;
  if (g < 0) return;
  // the run's rows, tile-relative
  const int lo = max(off[g], m0) - m0, hi = min(g < E ? off[g + 1] : M, m0 + BM) - m0;
  if (g == E) {  // rows past the last group are zeros
    for (int i = threadIdx.x; i < (hi - lo) * (BN / 4); i += kThreads) {
      const int r = m0 + lo + i / (BN / 4), c = n0 + (i % (BN / 4)) * 4;
      if (c < N)
        *reinterpret_cast<float4*>(out + (int64_t)r * N + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const float* w = rhs + (int64_t)g * K * N;
  float* as = sm;                            // [kStages][BM][kLdk]
  float* bs = as + kStages * kGmmA;          // [kStages] x kGmmB
  float* at = bs + kStages * kGmmB<TRANS>;   // [2][BK][BM], swizzled
  float* bt = at + 2 * kTgmmA;               // TRANS: [2][BK][BN], swizzled
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      gmm_copy<TRANS>(as + s * kGmmA, bs + s * kGmmB<TRANS>, lhs, w, M, K, N, m0, n0, s * BK);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // stage 0
  __syncthreads();
  gmm_transpose<TRANS>(at, bt, as, bs);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 3>();  // this thread's copies of stage kt + 1 landed
    // everyone's did; stage kt's transposes are written; everyone is done
    // with stage kt - 1's buffers and with transposing stage kt
    __syncthreads();
    const int next = kt + kStages - 1, slot = next % kStages;
    if (next < nk)
      gmm_copy<TRANS>(as + slot * kGmmA, bs + slot * kGmmB<TRANS>, lhs, w, M, K, N, m0, n0,
                      next * BK);
    cp_async_commit();
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      const int ahead = (kt + 1) % kStages;
      gmm_transpose<TRANS>(at + (cur ^ 1) * kTgmmA, bt + (cur ^ 1) * kTgmmB,
                           as + ahead * kGmmA, bs + ahead * kGmmB<TRANS>);
    }
    products<true, TRANS>(acc, at + cur * kTgmmA,
                          TRANS ? bt + cur * kTgmmB : bs + (kt % kStages) * kGmmB<TRANS>);
  }
  cp_async_wait<0>();
  store_rows(out, N, acc, m0, n0, lo, hi);
}

// ---------------------------------------------------------------- tgmm
// One stage: rows r0..r0 + 15 of lhs (columns k0..) into as [BK][BM] and of
// grad (columns n0..) into bs [BK][BN]; rows at or past `end` and columns
// past K or N read zeros in both.
__device__ __forceinline__ void tgmm_copy(float* as, float* bs, const float* lhs, const float* grad,
                                          int K, int N, int k0, int n0, int r0, int end) {
  constexpr int kRowM = BM / 4, kRowN = BN / 4;  // 16-byte copies a row
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < BK * kRowM / kThreads; ++q) {
    const int c = t + q * kThreads, r = c / kRowM, k = (c % kRowM) * 4;
    const bool ok = r0 + r < end && k0 + k < K;
    cp_async16(as + r * BM + k, ok ? lhs + (int64_t)(r0 + r) * K + k0 + k : lhs, ok);
  }
#pragma unroll
  for (int q = 0; q < BK * kRowN / kThreads; ++q) {
    const int c = t + q * kThreads, r = c / kRowN, n = (c % kRowN) * 4;
    const bool ok = r0 + r < end && n0 + n < N;
    cp_async16(bs + r * BN + n, ok ? grad + (int64_t)(r0 + r) * N + n0 + n : grad, ok);
  }
}

// Block (x, g): group g's tile (x % tiles_k, x / tiles_k) of its [K, N]
// output, K tiles fastest
__global__ void __launch_bounds__(kThreads, 1)
tgmm_ffma_kernel(const float* __restrict__ lhs, const float* __restrict__ grad,
                 const int* __restrict__ sizes, float* __restrict__ out, int M, int K, int N,
                 int E) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int off[kMaxGroups + 1];
  const int tiles_k = (K + BM - 1) / BM;
  const int k0 = (blockIdx.x % tiles_k) * BM, n0 = (blockIdx.x / tiles_k) * BN, g = blockIdx.y;
  group_offsets(sizes, E, M, off);
  const int start = off[g], end = off[g + 1];
  float* as = sm;
  float* bs = sm + kStages * kTgmmA;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  const int ns = (end - start + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ns)
      tgmm_copy(as + s * kTgmmA, bs + s * kTgmmB, lhs, grad, K, N, k0, n0, start + s * BK, end);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1, slot = next % kStages;
    if (next < ns)
      tgmm_copy(as + slot * kTgmmA, bs + slot * kTgmmB, lhs, grad, K, N, k0, n0,
                start + next * BK, end);
    cp_async_commit();
    products<false, false>(acc, as + (s % kStages) * kTgmmA, bs + (s % kStages) * kTgmmB);
  }
  cp_async_wait<0>();
  // out[g] as a row-major [K, N] matrix; rows past K are clipped
  store_rows(out + (int64_t)g * K * N, N, acc, k0, n0, 0, min(BM, K - k0));
}

// ---------------------------------------------------------------- host
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool TRANS>
int launch_gmm(const float* lhs, const float* rhs, const int* sizes, float* out, int M, int K,
               int N, int E, cudaStream_t st) {
  constexpr int smem = kGmmSmem<TRANS>;
  const cudaError_t e = allow_smem(gmm_ffma_kernel<TRANS>, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(((M + BM - 1) / BM + E) * ((N + BN - 1) / BN));
  gmm_ffma_kernel<TRANS><<<blocks, kThreads, smem, st>>>(lhs, rhs, sizes, out, M, K, N, E);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int K, int N, int E) {
  return M < 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || E < 1 || E > kMaxGroups;
}

}  // namespace

// lhs [M, K], rhs [E, K, N] (transpose_rhs: [E, N, K]) fp32; group_sizes
// [E] int32 on the device; out [M, N] fp32.  K and N multiples of 8, E at
// most 64, any M; 16-byte aligned pointers.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int grouped_matmul_gmm_fp32(const void* lhs, const void* rhs, const void* group_sizes,
                                       void* out, int M, int K, int N, int E, int transpose_rhs,
                                       void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const float* l = static_cast<const float*>(lhs);
  const float* r = static_cast<const float*>(rhs);
  const int* s = static_cast<const int*>(group_sizes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transpose_rhs ? launch_gmm<true>(l, r, s, o, M, K, N, E, st)
                       : launch_gmm<false>(l, r, s, o, M, K, N, E, st);
}

// lhs [M, K] (the forward's lhs: the caller's lhs_t is its transpose) and
// grad [M, N] fp32; group_sizes [E] int32 on the device; out [E, K, N]
// fp32, every group written (zeros for a group without rows).
extern "C" int grouped_matmul_tgmm_fp32(const void* lhs, const void* grad,
                                        const void* group_sizes, void* out, int M, int K, int N,
                                        int E, void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  constexpr int smem = kTgmmSmem;
  const cudaError_t e = allow_smem(tgmm_ffma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((K + BM - 1) / BM) * ((N + BN - 1) / BN), E);
  tgmm_ffma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(grad),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
