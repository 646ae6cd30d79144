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
// against 2.3 ms for its ~3.1 GB at 3.35 TB/s.  The design is the simple
// register-tiled SGEMM that is right first:
//   - a block of 256 threads computes a 128 x 128 output tile, each thread
//     an 8 x 8 sub-tile (rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j
//     and 64 + tx*4 + j, so a warp's float4 reads of a shared row hit
//     distinct banks) by FFMA from shared memory; 64 fp32 accumulators a
//     thread;
//   - the reduction runs 8 deep a stage, double-buffered in shared memory
//     (2 x 2 x 8 x 128 floats, 16 KB), the next stage's global loads held
//     in registers while the current stage's products run: one float4 of
//     each operand a thread a stage; K and N are multiples of 8, so no
//     float4 straddles an edge;
//   - the group plan comes from shapes alone: every block reads the E
//     sizes and forms the offsets itself, so the host never waits for
//     routing.  gmm's grid is (m-tile, n-tile); a block visits each group
//     whose rows meet its 128 rows (a tile straddling a boundary is run
//     once per group it touches, with that group's rhs, and stores that
//     group's rows only), then writes zeros to its rows past the last
//     group.  tgmm's grid is (K tile x N tile, group); a block sums its
//     group's rows 8 at a time, zeroing the rows at or past the group's
//     end in both operand tiles (a neighbour's inf must not leak in as
//     0 * inf); a group without rows writes zeros.  Each output element is
//     written once, without atomics, so repeat calls give the same bits.
// Making it fast (a pipeline deeper than two stages, warp specialisation)
// is later work; its times are in PERF.md.
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
constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 8;              // reduction depth of a stage
constexpr int kMaxGroups = 64;

// off[0..E] = exclusive prefix sums of the group sizes, clamped to [0, M]
// (one thread)
__device__ __forceinline__ void group_offsets(const int* sizes, int E, int M, int* off) {
  int acc = 0;
  off[0] = 0;
  for (int g = 0; g < E; ++g) {
    acc = min(acc + max(min(sizes[g], M), 0), M);
    off[g + 1] = acc;
  }
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// 8 x 8 products of one stage from shared memory: a column of a [BK][BM]
// tile and a row of a [BK][BN] tile per depth step
__device__ __forceinline__ void stage_products(float (&acc)[8][8], const float (*as)[BM],
                                               const float (*bs)[BN], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the thread's output rows and columns (tile-relative)
__device__ __forceinline__ int out_row(int ty, int i) { return (i < 4 ? 0 : 60) + ty * 4 + i; }
__device__ __forceinline__ int out_col(int tx, int h) { return h * 64 + tx * 4; }

// acc rows within [lo, hi) (absolute) and columns < N to a row-major
// [*, N] output whose tile starts at (m0, n0)
__device__ __forceinline__ void store_rows(float* out, int64_t N, const float (&acc)[8][8],
                                           int m0, int n0, int lo, int hi, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + out_row(ty, i);
    if (r < lo || r >= hi) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + out_col(tx, h);
      if (c < N)
        *reinterpret_cast<float4*>(out + r * N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------- gmm
// One stage's global loads: A's 128 rows x 8 columns of lhs (a float4 of
// row t / 2 at column (t % 2) * 4), B's 8 x 128 of rhs[g] (a float4 of
// row t / 32 at column (t % 32) * 4; with TRANS, rhs[g] is [N, K]: a
// float4 of n-row t / 2 at k (t % 2) * 4).  Rows past M and columns past
// N read zeros.
template <bool TRANS>
__device__ __forceinline__ void gmm_load(float4& a, float4& b, const float* lhs, const float* rhs,
                                         int M, int K, int N, int m0, int n0, int k0, int t) {
  const int ar = m0 + t / 2, ac = k0 + (t % 2) * 4;
  a = ar < M ? *reinterpret_cast<const float4*>(lhs + (int64_t)ar * K + ac) : zero4();
  if (TRANS) {
    const int bn = n0 + t / 2, bk = k0 + (t % 2) * 4;
    b = bn < N ? *reinterpret_cast<const float4*>(rhs + (int64_t)bn * K + bk) : zero4();
  } else {
    const int bk = k0 + t / 32, bn = n0 + (t % 32) * 4;
    b = bn < N ? *reinterpret_cast<const float4*>(rhs + (int64_t)bk * N + bn) : zero4();
  }
}

template <bool TRANS>
__device__ __forceinline__ void gmm_stash(const float4& a, const float4& b, float (*as)[BM],
                                          float (*bs)[BN], int t) {
  const int ar = t / 2, ac = (t % 2) * 4;
  as[ac][ar] = a.x;
  as[ac + 1][ar] = a.y;
  as[ac + 2][ar] = a.z;
  as[ac + 3][ar] = a.w;
  if (TRANS) {
    const int bn = t / 2, bk = (t % 2) * 4;
    bs[bk][bn] = b.x;
    bs[bk + 1][bn] = b.y;
    bs[bk + 2][bn] = b.z;
    bs[bk + 3][bn] = b.w;
  } else {
    *reinterpret_cast<float4*>(&bs[t / 32][(t % 32) * 4]) = b;
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
gmm_ffma_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                const int* __restrict__ sizes, float* __restrict__ out, int M, int K, int N, int E) {
  __shared__ int off[kMaxGroups + 1];
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (t == 0) group_offsets(sizes, E, M, off);
  __syncthreads();
  const int nk = K / BK;
  for (int g = 0; g < E; ++g) {
    const int lo = max(off[g], m0), hi = min(off[g + 1], m0 + BM);
    if (lo >= hi) continue;  // the same in every thread: off is shared
    const float* w = rhs + (int64_t)g * K * N;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float4 a, b;
    gmm_load<TRANS>(a, b, lhs, w, M, K, N, m0, n0, 0, t);
    __syncthreads();  // the last group's products are done with stage 0
    gmm_stash<TRANS>(a, b, as[0], bs[0], t);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) gmm_load<TRANS>(a, b, lhs, w, M, K, N, m0, n0, (kt + 1) * BK, t);
      stage_products(acc, as[cur], bs[cur], tx, ty);
      // the other buffer was last read by the stage before: the barrier
      // that ended it guards the stash
      if (kt + 1 < nk) gmm_stash<TRANS>(a, b, as[cur ^ 1], bs[cur ^ 1], t);
      __syncthreads();
    }
    store_rows(out, N, acc, m0, n0, lo, hi, tx, ty);
  }
  // rows past the last group are zeros
  const int zlo = max(off[E], m0), zhi = min(M, m0 + BM);
  for (int i = t; i < (zhi > zlo ? (zhi - zlo) * (BN / 4) : 0); i += kThreads) {
    const int r = zlo + i / (BN / 4), c = n0 + (i % (BN / 4)) * 4;
    if (c < N) *reinterpret_cast<float4*>(out + (int64_t)r * N + c) = zero4();
  }
}

// ---------------------------------------------------------------- tgmm
// One stage: 8 rows [r0, r0 + 8) of lhs (columns k0.. of K) and of grad
// (columns n0.. of N), a float4 of row t / 32 at column (t % 32) * 4 each;
// rows at or past `end` read zeros in both.
__device__ __forceinline__ void tgmm_load(float4& a, float4& b, const float* lhs, const float* grad,
                                          int K, int N, int k0, int n0, int r0, int end, int t) {
  const int r = r0 + t / 32, c = (t % 32) * 4;
  const bool live = r < end;
  a = live && k0 + c < K ? *reinterpret_cast<const float4*>(lhs + (int64_t)r * K + k0 + c)
                         : zero4();
  b = live && n0 + c < N ? *reinterpret_cast<const float4*>(grad + (int64_t)r * N + n0 + c)
                         : zero4();
}

__global__ void __launch_bounds__(kThreads, 2)
tgmm_ffma_kernel(const float* __restrict__ lhs, const float* __restrict__ grad,
                 const int* __restrict__ sizes, float* __restrict__ out, int M, int K, int N,
                 int E) {
  __shared__ int off[kMaxGroups + 1];
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int tiles_n = (N + BN - 1) / BN;
  const int k0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int g = blockIdx.y;
  if (t == 0) group_offsets(sizes, E, M, off);
  __syncthreads();
  const int start = off[g], end = off[g + 1];
  const int ns = (end - start + BK - 1) / BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (ns > 0) {
    float4 a, b;
    tgmm_load(a, b, lhs, grad, K, N, k0, n0, start, end, t);
    *reinterpret_cast<float4*>(&as[0][t / 32][(t % 32) * 4]) = a;
    *reinterpret_cast<float4*>(&bs[0][t / 32][(t % 32) * 4]) = b;
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const int cur = s & 1;
      if (s + 1 < ns) tgmm_load(a, b, lhs, grad, K, N, k0, n0, start + (s + 1) * BK, end, t);
      stage_products(acc, as[cur], bs[cur], tx, ty);
      if (s + 1 < ns) {
        *reinterpret_cast<float4*>(&as[cur ^ 1][t / 32][(t % 32) * 4]) = a;
        *reinterpret_cast<float4*>(&bs[cur ^ 1][t / 32][(t % 32) * 4]) = b;
      }
      __syncthreads();
    }
  }
  // out[g] as a row-major [K, N] matrix; rows past K are clipped
  store_rows(out + (int64_t)g * K * N, N, acc, k0, n0, 0, K, tx, ty);
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
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const float* l = static_cast<const float*>(lhs);
  const float* r = static_cast<const float*>(rhs);
  const int* s = static_cast<const int*>(group_sizes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transpose_rhs)
    gmm_ffma_kernel<true><<<grid, kThreads, 0, st>>>(l, r, s, o, M, K, N, E);
  else
    gmm_ffma_kernel<false><<<grid, kThreads, 0, st>>>(l, r, s, o, M, K, N, E);
  return (int)cudaGetLastError();
}

// lhs [M, K] (the forward's lhs: the caller's lhs_t is its transpose) and
// grad [M, N] fp32; group_sizes [E] int32 on the device; out [E, K, N]
// fp32, every group written (zeros for a group without rows).
extern "C" int grouped_matmul_tgmm_fp32(const void* lhs, const void* grad,
                                        const void* group_sizes, void* out, int M, int K, int N,
                                        int E, void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  const dim3 grid(((K + BM - 1) / BM) * ((N + BN - 1) / BN), E);
  tgmm_ffma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(grad),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
