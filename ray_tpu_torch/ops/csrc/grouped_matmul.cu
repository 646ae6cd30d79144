// Grouped matrix products for Hopper (sm_90a), bf16 in, fp32 accumulation,
// bf16 out: the port's megablox gmm and tgmm.
//
// Replaces jax's Pallas TPU library kernels megablox/gmm.py:gmm (pallas_call
// at gmm.py:526) and :tgmm (pallas_call at gmm.py:763), which
// ray_tpu/models/moe.py:_grouped_matmul calls through megablox/ops.py's
// custom VJP:
//
//   gmm   out[m, :] = lhs[m, :] @ rhs[g(m)]         lhs [M, K], rhs [E, K, N]
//         transpose_rhs: rhs [E, N, K] and out[m, :] = lhs[m, :] @ rhs[g(m)]^T
//   tgmm  out[g] = lhs[rows of g, :]^T @ grad[rows of g, :]
//                                  lhs [M, K], grad [M, N], out [E, K, N]
//
// where the rows of group g are [off[g], off[g + 1]), off being the
// exclusive prefix sum of group_sizes [E] (int32, on the device).  tgmm
// reads lhs in its forward layout [M, K] (the caller's lhs_t [K, M] is a
// transposed view), so the backward pass copies no activation.
//
// What bounds it on the H100: operations.  At the MoE training shapes
// (M = 16384 rows = 8192 tokens x top-2, K = 4096, N = 14336, E = 8) each
// call is 2 M K N = 1.924e12 flops, 1.946 ms at the 989 TFLOP/s bf16 peak,
// on ~1.54 GB of inputs and outputs, 0.46 ms at 3.35 TB/s.  So the products
// run on the tensor cores: mma.sync m16n8k16 (bf16 operands, fp32
// accumulation), fragments read with ldmatrix from a 3-stage cp.async ring
// of 32-deep tiles, 8 warps (2 x 4, 64 x 32 each) per 128 x 128 output tile.
// Output tiles are rastered 16 tile-rows at a time, so the blocks in flight
// share their operand tiles in L2.  No wgmma, TMA or persistent scheduler
// yet: that is the performance work left for later.
//
// Not the TPU design.  megablox builds a grid of (m-tile, group) visits
// from group metadata (make_group_metadata) and revisits an output tile
// once per group in its sequential Pallas grid.  Here:
//   - group offsets stay on the device: every block reads the E sizes and
//     forms the prefix sums itself, so the host never waits for routing;
//   - gmm: one block per 128 x 128 output tile over all M rows.  A tile
//     that straddles group boundaries runs its K loop once for each group
//     it touches, with that group's rhs, and stores that group's rows only
//     (rows are independent, so loads need no group mask), as megablox
//     visits such a tile once per group.  Rows past the last group are
//     written as zeros;
//   - tgmm: one block per (group, 128-row K tile, 128-column N tile) loops
//     over its group's rows 32 at a time and writes its tile once: no
//     atomics, so it is deterministic (the recompute under
//     torch.utils.checkpoint sees the same bits).  A group without rows
//     writes zeros.
// Rounding points are megablox's: exact bf16 products, fp32 sums, one
// rounding to bf16 at the output.  The plain versions
// (gmm_reference / tgmm_reference in ray_tpu_torch/ops/grouped_matmul.py)
// round at the same points, so only the summation order differs.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along the output rows, 4 along the columns
constexpr int BM = 128, BN = 128, BK = 32, kStages = 3;
constexpr int kMaxGroups = 64;
constexpr int kRasterRows = 16;  // tile rows per raster group
// shared row strides (bf16 elements), padded by 8 so that the 8 rows one
// ldmatrix reads start in distinct banks
constexpr int LD_K = BK + 8;  // tiles whose rows are 32 deep (along the reduction)
constexpr int LD_W = BN + 8;  // tiles whose rows are 128 wide

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even); `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments of the mma.sync m16n8k16 operands, one ldmatrix.x4 each.  Lane
// l addresses row l % 8 of 8 x 8 matrix l / 8.
//
// A (16 x 16) at rows r0.., reduction k0.., of a tile stored [row][k]
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s, int ld, int r0,
                                       int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4(a, s + (r0 + r + (q & 1) * 8) * ld + k0 + (q >> 1) * 8);
}

// the same A fragment from a tile stored [k][row]
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], const uint16_t* s, int ld,
                                             int r0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4_trans(a, s + (k0 + r + (q >> 1) * 8) * ld + r0 + (q & 1) * 8);
}

// B (16 x 8) of the two column tiles n0.. and n0 + 8.. (b[0..1] and
// b[2..3]), reduction k0.., from a tile stored [k][n]
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const uint16_t* s, int ld, int n0,
                                       int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b, s + (k0 + r + (q & 1) * 8) * ld + n0 + (q >> 1) * 8);
}

// the same B fragments from a tile stored [n][k]
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4], const uint16_t* s, int ld,
                                             int n0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4(b, s + (n0 + r + (q >> 1) * 8) * ld + k0 + (q & 1) * 8);
}

// ROWS x COLS bf16 of a row-major matrix (row stride ld) from (row0, col0)
// into shared (row stride LD), 16 bytes per copy; rows >= row_end and
// columns >= col_end (a multiple of 8) read as zeros
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, int64_t ld,
                                          int row0, int row_end, int col0, int col_end) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < row_end && col0 + c < col_end;
    cp_async16(dst + r * LD + c, ok ? src + (int64_t)(row0 + r) * ld + col0 + c : src, ok);
  }
}

// One 32-deep stage of the warp's 64 x 32 product: 4 x 4 mma tiles, two
// k16 steps.  A_TRANS: the A tile is stored [k][row]; B_TRANS: the B tile
// is stored [n][k].
template <bool A_TRANS, bool B_TRANS>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], const uint16_t* sa, int lda,
                                          const uint16_t* sb, int ldb, int wm, int wn,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (B_TRANS) {
        frag_b_trans(b[j], sb, ldb, wn + j * 16, kk, lane);
      } else {
        frag_b(b[j], sb, ldb, wn + j * 16, kk, lane);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4];
      if constexpr (A_TRANS) {
        frag_a_trans(a, sa, lda, wm + i * 16, kk, lane);
      } else {
        frag_a(a, sa, lda, wm + i * 16, kk, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16(acc[i][j], a, b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
}

// The cp.async ring: stage s of kStages holds tile t = s (mod kStages);
// load(stage, t) issues tile t's copies, compute(stage) consumes a stage.
// Leaves every copy done and every warp past its last read of shared.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int ntiles, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage (t - 1) is free
    const int next = t + kStages - 1;
    if (next < ntiles) load(next % kStages, next);
    cp_async_commit();
    compute(t % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the warp's accumulators to bf16 rows [lo, hi) and columns < col_end of a
// row-major output (row stride ld); the warp's tile starts at (row0, col0)
__device__ __forceinline__ void store_tile(uint16_t* out, int64_t ld,
                                           const float (&acc)[4][4][4], int row0, int col0,
                                           int lo, int hi, int col_end, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + i * 16 + g + h * 8;
      if (r < lo || r >= hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        if (c < col_end) {
          *reinterpret_cast<uint32_t*>(out + (int64_t)r * ld + c) =
              pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// off[0..E] = exclusive prefix sums of the group sizes, clamped to [0, M]
__device__ __forceinline__ void group_offsets(const int* sizes, int E, int M, int* off) {
  if (threadIdx.x == 0) {
    int acc = 0;
    off[0] = 0;
    for (int g = 0; g < E; ++g) {
      acc = min(acc + max(min(sizes[g], M), 0), M);
      off[g + 1] = acc;
    }
  }
  __syncthreads();
}

// block pid -> output tile (tr, tc), walking kRasterRows tile rows at a
// time down each column of tiles
__device__ __forceinline__ void raster(int pid, int tiles_r, int tiles_c, int& tr, int& tc) {
  const int per_group = kRasterRows * tiles_c;
  const int first = (pid / per_group) * kRasterRows;
  const int rows = min(tiles_r - first, kRasterRows);
  const int in_group = pid % per_group;
  tr = first + in_group % rows;
  tc = in_group / rows;
}

template <bool TRANS_RHS>
__host__ __device__ constexpr int gmm_stage_elems() {
  return BM * LD_K + (TRANS_RHS ? BN * LD_K : BK * LD_W);
}

constexpr int kTgmmStageElems = 2 * BK * LD_W;

template <bool TRANS_RHS>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const uint16_t* __restrict__ lhs, const uint16_t* __restrict__ rhs,
           const int* __restrict__ sizes, uint16_t* __restrict__ out, int M, int K, int N,
           int E) {
  constexpr int A_ELEMS = BM * LD_K;
  constexpr int STAGE = gmm_stage_elems<TRANS_RHS>();
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  __shared__ int off[kMaxGroups + 1];

  int tile_m, tile_n;
  raster(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tile_m, tile_n);
  const int m0 = tile_m * BM, n0 = tile_n * BN, m_end = min(m0 + BM, M);
  group_offsets(sizes, E, M, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int ktiles = (K + BK - 1) / BK;

  for (int g = 0; g < E; ++g) {
    const int lo = max(off[g], m0), hi = min(off[g + 1], m_end);
    if (lo >= hi) continue;  // block-uniform
    const uint16_t* w = rhs + (int64_t)g * K * N;
    float acc[4][4][4] = {};
    pipeline(
        ktiles,
        [&](int s, int kt) {
          uint16_t* sa = ring + s * STAGE;
          uint16_t* sb = sa + A_ELEMS;
          load_tile<BM, BK, LD_K>(sa, lhs, K, m0, M, kt * BK, K);
          if constexpr (TRANS_RHS) {
            load_tile<BN, BK, LD_K>(sb, w, K, n0, N, kt * BK, K);
          } else {
            load_tile<BK, BN, LD_W>(sb, w, N, kt * BK, K, n0, N);
          }
        },
        [&](int s) {
          const uint16_t* sa = ring + s * STAGE;
          mma_stage<false, TRANS_RHS>(acc, sa, LD_K, sa + A_ELEMS, TRANS_RHS ? LD_K : LD_W, wm,
                                      wn, lane);
        });
    store_tile(out, N, acc, m0 + wm, n0 + wn, lo, hi, N, lane);
  }

  // rows past the last group: zeros
  const int z0 = max(off[E], m0);
  const int chunks = min(BN, N - n0) / 8;
  for (int i = threadIdx.x; i < (m_end - z0) * chunks; i += kThreads) {
    const int r = z0 + i / chunks, c = n0 + (i % chunks) * 8;
    *reinterpret_cast<uint4*>(out + (int64_t)r * N + c) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
tgmm_kernel(const uint16_t* __restrict__ lhs, const uint16_t* __restrict__ grad,
            const int* __restrict__ sizes, uint16_t* __restrict__ out, int M, int K, int N,
            int E) {
  constexpr int A_ELEMS = BK * LD_W;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  __shared__ int off[kMaxGroups + 1];

  const int g = blockIdx.y;
  int tile_k, tile_n;
  raster(blockIdx.x, (K + BM - 1) / BM, (N + BN - 1) / BN, tile_k, tile_n);
  const int k0 = tile_k * BM, n0 = tile_n * BN;
  group_offsets(sizes, E, M, off);
  const int start = off[g], end = off[g + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4] = {};
  pipeline(
      (end - start + BK - 1) / BK,
      [&](int s, int mt) {
        uint16_t* sa = ring + s * kTgmmStageElems;
        const int mr = start + mt * BK;
        load_tile<BK, BM, LD_W>(sa, lhs, K, mr, end, k0, K);
        load_tile<BK, BN, LD_W>(sa + A_ELEMS, grad, N, mr, end, n0, N);
      },
      [&](int s) {
        const uint16_t* sa = ring + s * kTgmmStageElems;
        mma_stage<true, false>(acc, sa, LD_W, sa + A_ELEMS, LD_W, wm, wn, lane);
      });
  store_tile(out + (int64_t)g * K * N, N, acc, k0 + wm, n0 + wn, k0, min(k0 + BM, K), N, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int M, int K, int N, int E) {
  return M < 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 || E <= 0 || E > kMaxGroups;
}

template <bool TRANS_RHS>
cudaError_t launch_gmm(const uint16_t* lhs, const uint16_t* rhs, const int* sizes, uint16_t* out,
                       int M, int K, int N, int E, cudaStream_t st) {
  constexpr int smem = kStages * gmm_stage_elems<TRANS_RHS>() * 2;
  cudaError_t e = allow_smem(gmm_kernel<TRANS_RHS>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gmm_kernel<TRANS_RHS><<<tiles, kThreads, smem, st>>>(lhs, rhs, sizes, out, M, K, N, E);
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K], rhs [E, K, N] (transpose_rhs: [E, N, K]) bf16; group_sizes
// [E] int32 on the device; out [M, N] bf16.  K and N multiples of 8, E at
// most 64, any M.  Returns the cudaError_t of the launch (0 on success).
extern "C" int grouped_matmul_gmm_bf16(const void* lhs, const void* rhs, const void* group_sizes,
                                       void* out, int M, int K, int N, int E, int transpose_rhs,
                                       void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const uint16_t* a = static_cast<const uint16_t*>(lhs);
  const uint16_t* b = static_cast<const uint16_t*>(rhs);
  const int* s = static_cast<const int*>(group_sizes);
  uint16_t* o = static_cast<uint16_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(transpose_rhs ? launch_gmm<true>(a, b, s, o, M, K, N, E, st)
                             : launch_gmm<false>(a, b, s, o, M, K, N, E, st));
}

// lhs [M, K] (the forward's lhs: the caller's lhs_t is its transpose) and
// grad [M, N] bf16; group_sizes [E] int32 on the device; out [E, K, N]
// bf16, every group written (zeros for a group without rows).
extern "C" int grouped_matmul_tgmm_bf16(const void* lhs, const void* grad,
                                        const void* group_sizes, void* out, int M, int K, int N,
                                        int E, void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  constexpr int smem = kStages * kTgmmStageElems * 2;
  cudaError_t e = allow_smem(tgmm_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((K + BM - 1) / BM) * ((N + BN - 1) / BN), E);
  tgmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(lhs), static_cast<const uint16_t*>(grad),
      static_cast<const int*>(group_sizes), static_cast<uint16_t*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
