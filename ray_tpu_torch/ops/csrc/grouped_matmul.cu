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
// on ~1.54 GB of inputs and outputs, 0.46 ms at 3.35 TB/s.  So the design
// is the one that keeps Hopper's tensor cores fed (hopper.cuh):
//   - wgmma m64n256k16: each block computes a 128 x 256 output tile, 64
//     rows per consumer warpgroup (128 fp32 accumulators a thread), both
//     operands read from shared memory through descriptors.  Every operand
//     is read in its own layout by the descriptors' transpose bits, never
//     copied: gmm's lhs K-major, rhs MN-major (K-major with transpose_rhs);
//     tgmm's lhs rows (A) and grad rows (B) both MN-major;
//   - TMA loads: one thread of a producer warpgroup, which gives its
//     registers to the consumers (setmaxnreg), loads 128-byte-swizzled
//     tiles into a 4-stage ring of 64-deep stages (16 KB of A and 32 KB of
//     B each, 192 KB), with a full and an empty mbarrier per stage; a
//     consumer waits on its stage alone, keeps one wgmma group in flight
//     and frees the stage before it.  K tails read zeros: rhs is a 3D
//     tensor map [E, K, N] (or [E, N, K]), so no stage reads the next
//     expert's rows;
//   - TMA stores: a consumer rounds its tile to bf16 into 16 KB of
//     swizzled shared memory, half the columns at a time, and one thread
//     stores it by TMA, which runs on under the next item's products (a
//     tile that straddles a group boundary is stored from registers,
//     masked to the group's rows);
//   - persistent blocks: one per SM, each walking the same work list,
//     formed on the device from the group offsets, at items blockIdx.x,
//     blockIdx.x + gridDim.x, ...  The producer runs on into the next
//     item's loads while the consumers store the last one.
// Measured (chip_smoke.py phase 9, PERF.md): the kernels run at 60-67% of
// the bf16 peak, and with their products taken out they still take 70-100%
// of their time, so the loads set the pace.  Sharing the B tile between
// the two blocks of a cluster by TMA multicast, which halves its L2 reads,
// did not make them faster, and is not used.
//
// Not the TPU design.  megablox builds a grid of (m-tile, group) visits
// from group metadata (make_group_metadata) on the host side of its call
// and revisits an output tile once per group in its sequential Pallas
// grid.  Here:
//   - group offsets stay on the device: every block reads the E sizes and
//     forms the prefix sums and its work list itself, so the host never
//     waits for routing;
//   - gmm: items (group, 256-column n-tile, 128-row m-tile), m innermost,
//     so the ~16 m-tiles of a group reuse its rhs band from L2.  A tile
//     that straddles group boundaries is one item per group it touches,
//     each run with that group's rhs over all 128 rows and storing that
//     group's rows only (rows are independent, so loads need no mask).
//     Rows past the last group are written as zeros;
//   - tgmm: items (group, 128-row K tile, 256-column N tile), largest
//     group first (an item's cost follows its group's rows, so the long
//     ones go first and the tail is short), the smaller of K and N
//     innermost.  An item sums its group's rows
//     [start, end) 64 at a time, the first stage's box starting at row
//     `start`; in the last stage the rows at or past `end` hold the next
//     group, and the consumers zero them in both operand tiles before the
//     wgmma reads them (both: a non-finite value there must not leak in as
//     0 * inf).  Each output tile is written once, without atomics or
//     split-K, so repeat calls give the same bits (the recompute under
//     torch.utils.checkpoint sees the forward's); a group without rows
//     writes zeros.
// Rounding points are megablox's: exact bf16 products, fp32 sums, one
// rounding to bf16 at the output.  The plain versions
// (gmm_reference / tgmm_reference in ray_tpu_torch/ops/grouped_matmul.py)
// round at the same points, so only the summation order differs.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes; the tensor maps come
// from libcuda's cuTensorMapEncodeTiled (hopper.cuh), from pointers and
// shapes alone.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int BM = 128, BN = 256;   // output tile
constexpr int BK = 64;              // reduction depth of a stage
constexpr int kStages = 4;
constexpr int kMaxGroups = 64;
constexpr int BOX = 64 * 64 * 2;  // one swizzled [64 x 64] TMA box
constexpr int A_BYTES = BM * BK * 2;  // 16 KB: two boxes' worth
constexpr int B_BYTES = BK * BN * 2;  // 32 KB: four
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGING_BYTES = 2 * BOX;  // per consumer: half its 64 x 256 output
// the ring, the consumers' staging, the ring's 2 x kStages mbarriers, and
// room to align the ring to 1024 (231,312 bytes with the static Schedule,
// of the 232,448 a block may have)
constexpr int kSmem = kStages * STAGE_BYTES + 2 * STAGING_BYTES + 128 + 1024;

// The work list, the same in every block
struct Schedule {
  int off[kMaxGroups + 1];    // group g's rows: [off[g], off[g + 1])
  int first[kMaxGroups + 1];  // gmm: items before group g's
  int order[kMaxGroups];      // tgmm: groups by rows, most first
};

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

// m-tiles that rows [lo, hi) touch
__device__ __forceinline__ int tiles_of(int lo, int hi) {
  return hi > lo ? (hi - 1) / BM - lo / BM + 1 : 0;
}

// One gmm item: group g's rows [lo, hi) of the tile at (m0, n0)
struct Visit {
  int g, m0, n0, lo, hi;
};

// Item `item` of the gmm list; `g` carries the group over calls (a block's
// items only grow)
__device__ __forceinline__ Visit gmm_visit(const Schedule& sch, int item, int ntn, int& g) {
  while (item >= sch.first[g + 1]) ++g;
  const int lo = sch.off[g], hi = sch.off[g + 1];
  const int tiles = tiles_of(lo, hi);
  const int local = item - sch.first[g];
  Visit v;
  v.g = g;
  v.n0 = (local / tiles) * BN;
  v.m0 = (lo / BM + local % tiles) * BM;
  v.lo = max(lo, v.m0);
  v.hi = min(hi, v.m0 + BM);
  return v;
}

// A consumer's 64 x 256 accumulator to bf16 pairs at rows [lo, hi) and
// columns < col_end (a multiple of 8) of a row-major output (row stride
// ld): the thread's rows r and r + 8, columns c + 8j and c + 8j + 1
__device__ __forceinline__ void store_tile(uint16_t* out, int64_t ld, const float (&acc)[128],
                                           int r, int c, int lo, int hi, int col_end) {
  const bool ra = r >= lo && r < hi, rb = r + 8 >= lo && r + 8 < hi;
  uint16_t* pa = out + (int64_t)r * ld + c;
  uint16_t* pb = pa + 8 * ld;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (c + 8 * j < col_end) {
      if (ra) *reinterpret_cast<uint32_t*>(pa + 8 * j) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      if (rb) *reinterpret_cast<uint32_t*>(pb + 8 * j) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// A consumer's 64 x 256 accumulator to bf16 through its staging buffer
// and on by TMA stores: half the columns at a time, as two 128-byte-
// swizzled [64 x 64] boxes (the thread's pairs land in distinct banks),
// each stored by `store(box address, column offset)`; the tensor map
// clips rows and columns outside the output.  The stores run on under the
// next item's products: the buffer is waited for only when it is next
// written.  `bar` is the warpgroup's named barrier.
template <typename Store>
__device__ __forceinline__ void store_staged(const float (&acc)[128], uint32_t staging, int bar,
                                             int warp, int lane, Store store) {
  const int g = lane / 4, t = lane % 4;
  const uint32_t row = (16 * warp + g) * 128;  // the thread's first row; the second 8 on
  const bool leader = threadIdx.x % 128 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (leader) bulk_wait_read<0>();  // the last stores from the buffer have read it
    named_barrier(bar, 128);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * h + jj;
      const uint32_t at = staging + (jj / 8) * BOX + row + (((jj % 8) ^ g) << 4) + 4 * t;
      st_shared_b32(at, pack_bf16(acc[4 * j], acc[4 * j + 1]));
      st_shared_b32(at + 8 * 128, pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
    }
    fence_proxy_async();
    named_barrier(bar, 128);
    if (leader) {
      store(staging, 128 * h);
      store(staging + BOX, 128 * h + 64);
      bulk_commit();
    }
  }
}

// The consumers' side of one item's stages: wait for each stage, run its
// four k16 products, keep one wgmma group in flight and free the stage
// before it; `prepare(s, kt)` runs on a full stage before its products,
// `product(s, kk)` issues one.  `it` counts stages over the block's items.
template <typename Prepare, typename Product>
__device__ __forceinline__ void consume(float (&acc)[128], int nk, int& it, uint32_t full0,
                                        uint32_t empty0, int lane, Prepare prepare,
                                        Product product) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    prepare(s, kt);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) product(s, kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (nk > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
}

// the ring's barriers: full (the producer's arrival and the TMA bytes)
// and empty (one arrival per consumer warp); one thread
__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, 8);
  }
  mbar_fence_init();
}

// the producer's wait for stage `it % kStages` to be free
__device__ __forceinline__ uint32_t claim(int it, uint32_t empty0) {
  const int s = it % kStages;
  if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
  return s;
}

// ---------------------------------------------------------------- gmm
template <bool TRANS_RHS>
__global__ void __launch_bounds__(kThreads, 1)
gmm_kernel(const __grid_constant__ CUtensorMap tm_lhs, const __grid_constant__ CUtensorMap tm_rhs,
           const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ sizes,
           uint16_t* __restrict__ out, int M, int K, int N, int E) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Schedule sch;
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t staging0 = base + kStages * STAGE_BYTES;
  const uint32_t full0 = staging0 + 2 * STAGING_BYTES, empty0 = full0 + 8 * kStages;
  auto a_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_s = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };

  const int ntn = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    group_offsets(sizes, E, M, sch.off);
    sch.first[0] = 0;
    for (int g = 0; g < E; ++g) {
      sch.first[g + 1] = sch.first[g] + tiles_of(sch.off[g], sch.off[g + 1]) * ntn;
    }
    init_ring(full0, empty0);
  }
  __syncthreads();
  const int items = sch.first[E];

  if (wg == 0) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, g = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Visit v = gmm_visit(sch, item, ntn, g);
        // MN-major rhs: 64-column boxes, those wholly past N not loaded
        // (they feed only output columns that are not stored)
        const int boxes = TRANS_RHS ? 4 : min(4, (N - v.n0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = claim(it, empty0);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, A_BYTES + boxes * BOX);
          tma_load_2d(a_s(s), &tm_lhs, full, kt * BK, v.m0);
          if (TRANS_RHS) {
            tma_load_3d(b_s(s), &tm_rhs, full, kt * BK, v.n0, v.g);
          } else {
            for (int b = 0; b < boxes; ++b) {
              tma_load_3d(b_s(s) + b * BOX, &tm_rhs, full, v.n0 + 64 * b, kt * BK, v.g);
            }
          }
        }
      }
    }
  } else {  // consumers: 64 rows of the tile each
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r = 64 * c + 16 * warp + lane / 4;  // the thread's first row in the tile
    const int col = 2 * (lane % 4);
    float acc[128];
    int it = 0, g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Visit v = gmm_visit(sch, item, ntn, g);
      consume(
          acc, nk, it, full0, empty0, lane, [](int, int) {},
          [&](int s, int kk) {
            if constexpr (TRANS_RHS) {
              wgmma_ss_n256<0, 0>(acc, kmajor_desc<BM>(a_s(s), 64 * c, kk),
                                  kmajor_desc<BN>(b_s(s), 0, kk), 1);
            } else {
              wgmma_ss_n256<0, 1>(acc, kmajor_desc<BM>(a_s(s), 64 * c, kk),
                                  mnmajor_desc<BK>(b_s(s), kk), 1);
            }
          });
      // the warpgroup's 64 rows (those below M) all the visit's: by TMA;
      // some (a tile that straddles a group boundary): direct
      const int w0 = v.m0 + 64 * c;
      if (v.lo <= w0 && w0 < v.hi && min(w0 + 64, M) <= v.hi) {
        store_staged(acc, staging0 + c * STAGING_BYTES, 2 + c, warp, lane,
                     [&](uint32_t src, int dc) { tma_store_2d(&tm_out, src, v.n0 + dc, w0); });
      } else if (v.lo < w0 + 64 && w0 < v.hi) {
        store_tile(out, N, acc, v.m0 + r, v.n0 + col, v.lo, v.hi, N);
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();

    // rows past the last group: zeros, 16 bytes a store over the consumers
    // of every block
    const int z0 = sch.off[E], chunks = N / 8;
    const int64_t n = (int64_t)(M - z0) * chunks;
    for (int64_t i = blockIdx.x * 256 + (threadIdx.x - 128); i < n; i += gridDim.x * 256) {
      *reinterpret_cast<uint4*>(out + (z0 + i / chunks) * (int64_t)N + (i % chunks) * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// ---------------------------------------------------------------- tgmm
// The K and N tile origins of item `local` of a group's ntk x ntn items,
// the smaller of K and N innermost (k_inner: K < N).  The blocks in flight
// then read the larger operand's rows over a few tiles only, and only the
// smaller operand's in full: at K 4096, N 14336 a round of 132 items
// reads ~21 MB of a group's rows where N innermost would read ~60 MB,
// more than L2 holds.
__device__ __forceinline__ void tgmm_tile(int local, int ntk, int ntn, bool k_inner, int& k0,
                                          int& n0) {
  k0 = (k_inner ? local % ntk : local / ntn) * BM;
  n0 = (k_inner ? local / ntk : local % ntn) * BN;
}

// Zeroes rows [rows, BK) of a stage's six boxes (A's two, B's four), 16
// bytes a store over the 256 consumer threads (ct = 0..255)
__device__ __forceinline__ void zero_rows(uint8_t* stage, int rows, int ct) {
  const int per_box = (BK - rows) * 8;  // 16-byte chunks
  for (int i = ct; i < 6 * per_box; i += 256) {
    const int box = i / per_box, j = i % per_box;
    *reinterpret_cast<uint4*>(stage + box * BOX + (rows + j / 8) * 128 + (j % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tgmm_kernel(const __grid_constant__ CUtensorMap tm_lhs, const __grid_constant__ CUtensorMap tm_grad,
            const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ sizes, int M,
            int K, int N, int E) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Schedule sch;
  const uint32_t base = align1024(smem_addr(smem_raw));
  uint8_t* base_p = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t staging0 = base + kStages * STAGE_BYTES;
  const uint32_t full0 = staging0 + 2 * STAGING_BYTES, empty0 = full0 + 8 * kStages;
  auto a_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_s = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };

  const int ntk = (K + BM - 1) / BM, ntn = (N + BN - 1) / BN, per_group = ntk * ntn;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    group_offsets(sizes, E, M, sch.off);
    for (int g = 0; g < E; ++g) {  // insertion sort: most rows first, then lower index
      const int rows = sch.off[g + 1] - sch.off[g];
      int q = g;
      for (; q > 0; --q) {
        const int p = sch.order[q - 1];
        if (sch.off[p + 1] - sch.off[p] >= rows) break;
        sch.order[q] = p;
      }
      sch.order[q] = g;
    }
    init_ring(full0, empty0);
  }
  __syncthreads();
  const int items = E * per_group;

  if (wg == 0) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int g = sch.order[item / per_group], local = item % per_group;
        int k0, n0;
        tgmm_tile(local, ntk, ntn, K < N, k0, n0);
        const int start = sch.off[g], nk = (sch.off[g + 1] - start + BK - 1) / BK;
        // boxes wholly past K or N are not loaded: they feed only output
        // rows or columns that are not stored
        const int a_boxes = min(2, (K - k0 + 63) / 64), b_boxes = min(4, (N - n0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = claim(it, empty0);
          const uint32_t full = full0 + 8 * s;
          const int row = start + kt * BK;
          mbar_expect_tx(full, (a_boxes + b_boxes) * BOX);
          for (int b = 0; b < a_boxes; ++b) {
            tma_load_2d(a_s(s) + b * BOX, &tm_lhs, full, k0 + 64 * b, row);
          }
          for (int b = 0; b < b_boxes; ++b) {
            tma_load_2d(b_s(s) + b * BOX, &tm_grad, full, n0 + 64 * b, row);
          }
        }
      }
    }
  } else {  // consumers: 64 rows of K each (A's box c)
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[128];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int g = sch.order[item / per_group], local = item % per_group;
      int k0, n0;
      tgmm_tile(local, ntk, ntn, K < N, k0, n0);
      const int start = sch.off[g], end = sch.off[g + 1];
      consume(
          acc, (end - start + BK - 1) / BK, it, full0, empty0, lane,
          [&](int s, int kt) {
            // the last stage's rows at or past `end` are the next group's
            const int rows = end - (start + kt * BK);
            if (rows < BK) {
              zero_rows(base_p + s * STAGE_BYTES, rows, threadIdx.x - 128);
              fence_proxy_async();
              named_barrier(1, 256);
            }
          },
          [&](int s, int kk) {
            wgmma_ss_n256<1, 1>(acc, mnmajor_desc<BK>(a_s(s) + c * BOX, kk),
                                mnmajor_desc<BK>(b_s(s), kk), 1);
          });
      if (k0 + 64 * c < K) {  // rows past K: clipped by the [E, K, N] map
        store_staged(acc, staging0 + c * STAGING_BYTES, 2 + c, warp, lane,
                     [&](uint32_t src, int dc) {
                       tma_store_3d(&tm_out, src, n0 + dc, k0 + 64 * c, g);
                     });
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();
  }
}

// ------------------------------------------------------------------- host
bool bad_shape(int M, int K, int N, int E) {
  return M < 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 || E <= 0 || E > kMaxGroups;
}

// one persistent block per SM of the current device, at most `items`
cudaError_t grid_size(int64_t items, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = (int)(items < sms ? (items > 0 ? items : 1) : sms);
  return e;
}

// above 48 KB a kernel's dynamic shared memory needs an opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
}

// a row-major [rows x cols] bf16 matrix in boxes of box_rows x 64 columns
cudaError_t matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return bf16_tensor_map(map, ptr, 2, dims, strides, box);
}

#define RETURN_IF_ERROR(x)                  \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <bool TRANS_RHS>
int launch_gmm(const void* lhs, const void* rhs, const int* sizes, uint16_t* out, int M, int K,
               int N, int E, cudaStream_t st) {
  RETURN_IF_ERROR(allow_smem(gmm_kernel<TRANS_RHS>));
  CUtensorMap ml, mr, mo;
  RETURN_IF_ERROR(matrix_map(&ml, lhs, M, K, BM));
  RETURN_IF_ERROR(matrix_map(&mo, out, M, N, 64));
  // rhs[g] as [K, N] (MN-major: boxes of 64 rows of K x 64 columns of N)
  // or, with transpose_rhs, [N, K] (K-major: 256 rows of N x 64 of K)
  const int inner = TRANS_RHS ? K : N, outer = TRANS_RHS ? N : K;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * outer * 2};
  const cuuint32_t box[3] = {64, TRANS_RHS ? (cuuint32_t)BN : (cuuint32_t)BK, 1};
  RETURN_IF_ERROR(bf16_tensor_map(&mr, rhs, 3, dims, strides, box));
  // items: the m-tiles, one more for each group boundary inside a tile,
  // times the n-tiles
  int grid;
  RETURN_IF_ERROR(grid_size((int64_t)((M + BM - 1) / BM + E - 1) * ((N + BN - 1) / BN), grid));
  gmm_kernel<TRANS_RHS><<<grid, kThreads, kSmem, st>>>(ml, mr, mo, sizes, out, M, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// lhs [M, K], rhs [E, K, N] (transpose_rhs: [E, N, K]) bf16; group_sizes
// [E] int32 on the device; out [M, N] bf16.  K and N multiples of 8, E at
// most 64, any M; 16-byte aligned pointers.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int grouped_matmul_gmm_bf16(const void* lhs, const void* rhs, const void* group_sizes,
                                       void* out, int M, int K, int N, int E, int transpose_rhs,
                                       void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const int* s = static_cast<const int*>(group_sizes);
  uint16_t* o = static_cast<uint16_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transpose_rhs ? launch_gmm<true>(lhs, rhs, s, o, M, K, N, E, st)
                       : launch_gmm<false>(lhs, rhs, s, o, M, K, N, E, st);
}

// lhs [M, K] (the forward's lhs: the caller's lhs_t is its transpose) and
// grad [M, N] bf16; group_sizes [E] int32 on the device; out [E, K, N]
// bf16, every group written (zeros for a group without rows).
extern "C" int grouped_matmul_tgmm_bf16(const void* lhs, const void* grad,
                                        const void* group_sizes, void* out, int M, int K, int N,
                                        int E, void* stream) {
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) {  // every group empty; a tensor map needs rows
    return (int)cudaMemsetAsync(out, 0, (size_t)E * K * N * 2, st);
  }
  RETURN_IF_ERROR(allow_smem(tgmm_kernel));
  CUtensorMap ml, mg, mo;
  RETURN_IF_ERROR(matrix_map(&ml, lhs, M, K, BK));
  RETURN_IF_ERROR(matrix_map(&mg, grad, M, N, BK));
  // out as [E, K, N], so that a K tail is clipped within each group's slice
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  RETURN_IF_ERROR(bf16_tensor_map(&mo, out, 3, dims, strides, box));
  const int64_t items = (int64_t)E * ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  int grid;
  RETURN_IF_ERROR(grid_size(items, grid));
  tgmm_kernel<<<grid, kThreads, kSmem, st>>>(ml, mg, mo, static_cast<const int*>(group_sizes),
                                             M, K, N, E);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
