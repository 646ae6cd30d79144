// Paged decode attention for Hopper (sm_90a), bf16 pool, fp32 output.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py:_kernel.
// Same function: single-query GQA attention of each batch row against its
// own pages of the block pool [L, NB, bs, kvh*HD], over the span
// lengths[b] + 1 (the decode step writes the new token's K/V before it
// attends), returning [B, nh*HD] in fp32.
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its live K
// and V span once (2 * span * HD * 2 bytes) and does 4 * G flops per byte
// pair it reads, far below the ~295 flops/byte where the tensor cores would
// become the limit.  At the decode path's shapes (8 rows, 8 kv heads, spans
// of a few hundred to a few thousand tokens) a call moves ~17 MB, 5 us at
// 3.35 TB/s, so the design puts every SM to work on the bytes at once and
// spends few instructions per byte:
//   - split-KV: each (row, kv head) span is cut into splits of
//     `split_tokens` (ops/paged_attention.py:split_plan, from the shapes
//     and the SM count alone: 512 tokens unless the table is short), one
//     block each, over a grid (kvh, B, splits of the full table).  A block
//     past its row's span exits at once, so `lengths` is never read on the
//     host and the launch can be captured in a CUDA graph.  A split costs
//     its block a fixed latency (lengths and table reads, barrier set-up,
//     and for a split row the partial's write, an arrival and a merge), so
//     splits are long and the card's parallelism comes from rows, heads
//     and long spans;
//   - TMA page loads: warp 0 reads the split's table entries (lane j:
//     pieces j and j + 32) while lengths[b] is in flight, then issues one
//     2D TMA load per piece per 64 columns of the kv head, K and V, into a
//     three-stage ring of 64-token stages (96 KB) guarded by full/empty
//     mbarriers; a piece is a page, or a 64-row slice of one for block
//     sizes above 64.  Pages past the span are never loaded.  The tensor
//     maps are over the pool viewed as [L*NB*bs, kvh*HD] with 128-byte
//     swizzle, so the fragment reads below are free of bank conflicts; the
//     host caches them per pool;
//   - the GQA group on the tensor cores (mma.sync m16n8k16, bf16 operands,
//     fp32 sums): each of four consumer warps takes 16 tokens of a stage
//     as M and the group's q heads, padded to 8, as N.  S^T = K q^T reads K
//     by ldmatrix and q^T from registers (loaded once); the bf16 P^T tile
//     is transposed in registers (movmatrix) into the B operand of
//     O^T = V^T P^T, which reads V by ldmatrix.trans.  A warp spends ~70
//     instructions on a 16-token tile at HD 128 (8 KB of K and V): the
//     loads, not the CUDA cores, set the pace;
//   - the tail: TMA loads whole pieces, so rows past `lengths + 1` (stale
//     data, NaN in the tests) reach shared memory.  Their scores become
//     -inf by a select, and their V values are zeroed in the registers
//     that feed the PV product (0 * NaN is NaN on the tensor cores too),
//     so nothing is written back to shared memory and no proxy fence is
//     needed.  A stage's tiles wholly past the span are not read at all.
// Not a persistent kernel: one block per SM walking a work list was as
// fast at short spans and slower at long ones, because each item's merge
// then runs in series on its block, where here two resident blocks an SM
// hide each other's (PERF.md).
//
// Rounding points are the plain version's (attend_gathered in
// paged_attention.py): scores are bf16 products summed in fp32 and then
// multiplied by log2(e)/sqrt(HD) in fp32; exponentials exp2(s - m), with m
// the running max rounded up to a whole number, are summed in fp32 and
// rounded to bf16 only for the PV product.  Every rescale is an exact power
// of two, so the values rounded to bf16 are the plain version's.
//
// Merging: each warp keeps its own (m, l, acc); the block merges its four
// warps through shared memory in warp order.  A row with one split writes
// its output directly.  Otherwise each split writes its (m, l, acc) to an
// fp32 workspace sized from the shapes, and the last block of a (row, kv
// head) to arrive -- an arrival counter, bumped by one acquire-release
// atomic after the block's barrier and reset by that last block -- merges
// the splits in split order, with their loads in flight eight at a time:
// one launch per call, no atomics on any sum, and repeat calls give the
// same bits.  The counters persist between calls (zero at every kernel
// boundary), one set per device and stream.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStageTokens = 64;                    // a ring stage: 4 tiles of 16 tokens
constexpr int kConsumers = kStageTokens / 16;       // one warp per tile
constexpr int kThreads = 32 * (1 + kConsumers);     // warp 0 loads
constexpr int kStages = 3;  // 96 KB of K and V in flight a block, two blocks an SM
constexpr int kMaxSplits = 256;  // the merge stages every split's (max, sum) in the ring

// bytes of one tensor's part of a stage: HD/64 swizzled boxes of 64 rows
template <int HD>
constexpr int kTensorBytes = HD * kStageTokens * 2;

template <int HD>
constexpr int kSmemBytes = kStages * 2 * kTensorBytes<HD> + 1024;  // + alignment to 1024

// ---------------------------------------------------- mma.sync fragments
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the transpose of the 8 x 8 bf16 matrix whose row lane/4, columns
// 2(lane%4) and 2(lane%4)+1 this lane holds, in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory address of row r (0..63) and 16-byte chunk c (0..HD/8-1)
// of one tensor's part of a stage: HD/64 boxes of [64 rows x 128 bytes],
// each 128-byte swizzled as TMA wrote it (the chunk XOR the row mod 8)
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + (c >> 3) * (kStageTokens * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 2^(m - m_new), exact, for whole numbers m <= m_new; 0 for m = -inf
__device__ __forceinline__ float pow2_shift(float m, float m_new) {
  return m == -INFINITY ? 0.f : ldexpf(1.f, (int)(m - m_new));
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,  // pool as [L*NB*bs, kvh*HD]
                    const __grid_constant__ CUtensorMap tm_v,
                    const uint16_t* __restrict__ q,       // [B, nh, HD]
                    const int32_t* __restrict__ table,    // [B, W]
                    const int32_t* __restrict__ lengths,  // [B]
                    float* __restrict__ out,              // [B, nh*HD]
                    float* __restrict__ ws,               // partials: see below
                    int* __restrict__ arrivals,           // [B * kvh], zero between calls
                    int W, int bs, int piece, int layer_row0, int split_tokens,
                    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages];
  __shared__ int last_flag;

  const int kvh = gridDim.x, nsplit_max = gridDim.z;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nh = kvh * G;
  const int t0 = split * split_tokens;
  const int32_t* trow = table + (int64_t)b * W;
  // warp 0's lanes read the table entries of the split's first 64 pieces
  // (lane j: pieces j and j + 32) while lengths[b] is still in flight
  int rows_lo = 0, rows_hi = 0;
  if (threadIdx.x < 32) {
    const int tend = min(t0 + split_tokens, W * bs);
    const int ta = t0 + threadIdx.x * piece, tb = ta + 32 * piece;
    if (ta < tend) rows_lo = layer_row0 + __ldg(trow + ta / bs) * bs + ta % bs;
    if (tb < tend) rows_hi = layer_row0 + __ldg(trow + tb / bs) * bs + tb % bs;
  }
  // the span is lengths + 1; like the TPU kernel, never past the table
  const int nvalid = min(__ldg(lengths + b) + 1, W * bs);
  const int nsplit = max(1, (nvalid + split_tokens - 1) / split_tokens);
  if (split >= nsplit) return;  // past the row's span: the common exit
  const int t1 = min(t0 + split_tokens, nvalid);
  float* orow = out + ((int64_t)b * nh + h * G) * HD;
  if (t1 <= t0) {  // an empty span (lengths < 0) gives 0
    for (int e = threadIdx.x; e < G * HD; e += kThreads) orow[e] = 0.f;
    return;
  }
  const int nstage = (t1 - t0 + kStageTokens - 1) / kStageTokens;

  const uint32_t ring = align1024(smem_addr(smem_raw));
  float* ring_f = reinterpret_cast<float*>(smem_raw + (ring - smem_addr(smem_raw)));
  const uint32_t full0 = smem_addr(full_bar), empty0 = smem_addr(empty_bar);
  constexpr int TB = kTensorBytes<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // producer: lane j loads piece j of each stage, K and V, HD/64 boxes
    // each, from the entries read above (past the 64th piece, as a split
    // longer than 512 tokens has at block size 8, the lane reads its own)
    const int per_stage = kStageTokens / piece;
    for (int s = 0; s < nstage; ++s) {
      const int slot = s % kStages;
      const int st = t0 + s * kStageTokens;
      const int npieces = (min(st + kStageTokens, t1) - st + piece - 1) / piece;
      const int p = s * per_stage + lane;  // this lane's piece of the split
      const int lo = __shfl_sync(0xffffffffu, rows_lo, p & 31);
      const int hi = __shfl_sync(0xffffffffu, rows_hi, p & 31);
      if (s >= kStages) mbar_wait(empty0 + 8 * slot, ((s / kStages) - 1) & 1);
      const uint32_t full = full0 + 8 * slot;
      if (lane == 0) mbar_expect_tx(full, npieces * piece * HD * 2 * 2);
      __syncwarp();
      if (lane < npieces) {
        const int t = st + lane * piece;
        const int row =
            p < 32 ? lo : p < 64 ? hi : layer_row0 + __ldg(trow + t / bs) * bs + t % bs;
        const uint32_t kdst = ring + slot * 2 * TB + lane * piece * 128;
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_2d(kdst + c * (kStageTokens * 128), &tm_k, full, h * HD + 64 * c, row);
          tma_load_2d(kdst + TB + c * (kStageTokens * 128), &tm_v, full, h * HD + 64 * c, row);
        }
      }
    }
    return;
  }

  // consumers: warp cw takes tokens [16 cw, 16 cw + 16) of every stage
  const int cw = warp - 1, ct = threadIdx.x - 32;
  const int g = lane >> 2, tq = lane & 3;
  // q^T as the B operand of S^T = K q^T: head g (zero past the group),
  // dims 16 kk + 2 tq (+1) and 16 kk + 2 tq + 8 (+9)
  uint32_t qf[HD / 16][2];
  const uint16_t* qrow = q + ((int64_t)b * nh + h * G + min(g, G - 1)) * HD + 2 * tq;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qf[kk][0] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * kk)) : 0u;
    qf[kk][1] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8)) : 0u;
  }
  // online softmax state for heads 2 tq and 2 tq + 1 (m in log2 units, a
  // whole number; l this lane's partial sum); O^T rows d = 16 mt + g (+8)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
  }
  const int r_ld = lane & 7, mat = lane >> 3;  // ldmatrix: this lane's row and matrix

  for (int s = 0; s < nstage; ++s) {
    const int slot = s % kStages;
    const int live = min(kStageTokens, t1 - (t0 + s * kStageTokens)) - 16 * cw;
    mbar_wait(full0 + 8 * slot, (s / kStages) & 1);
    if (live > 0) {  // warp-uniform; token row 16 cw of the stage is live
      const uint32_t kbase = ring + slot * 2 * TB, vbase = kbase + TB;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int r = 16 * cw + (mat & 1) * 8 + r_ld;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, tile_addr(kbase, r, 2 * kk + (mat >> 1)));
          mma_bf16(sc, a, qf[kk][0], qf[kk][1]);
        }
      }
      // rows g and g + 8 of the tile are tokens; columns 2 tq, 2 tq + 1 heads
      const bool lo = g < live, hi = g + 8 < live;
      const float s0 = lo ? sc[0] * scale_log2 : -INFINITY;
      const float s1 = lo ? sc[1] * scale_log2 : -INFINITY;
      const float s2 = hi ? sc[2] * scale_log2 : -INFINITY;
      const float s3 = hi ? sc[3] * scale_log2 : -INFINITY;
      float c0 = fmaxf(s0, s2), c1 = fmaxf(s1, s3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
        c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
      }
      // finite: token 0 of the tile is live (a padded head scores 0)
      const float mn0 = fmaxf(m[0], ceilf(c0)), mn1 = fmaxf(m[1], ceilf(c1));
      const float corr0 = pow2_shift(m[0], mn0), corr1 = pow2_shift(m[1], mn1);
      m[0] = mn0;
      m[1] = mn1;
      const float p0 = exp2f(s0 - mn0), p1 = exp2f(s1 - mn1);
      const float p2 = exp2f(s2 - mn0), p3 = exp2f(s3 - mn1);
      l[0] = l[0] * corr0 + (p0 + p2);
      l[1] = l[1] * corr1 + (p1 + p3);
      // P^T (tokens x heads) rounded to bf16, transposed into the B
      // operand of O^T = V^T P^T: tokens 2 tq (+1), 2 tq + 8 (+9) of head g
      const uint32_t b0 = movmatrix_trans(pack_bf16(p0, p1));
      const uint32_t b1 = movmatrix_trans(pack_bf16(p2, p3));
      // V rows past the span: zero, in the A fragments (tokens 2 tq, 2 tq
      // + 1 in a[0], a[1]; 2 tq + 8, 2 tq + 9 in a[2], a[3])
      const uint32_t keep01 = (2 * tq < live ? 0x0000ffffu : 0u) |
                              (2 * tq + 1 < live ? 0xffff0000u : 0u);
      const uint32_t keep89 = (2 * tq + 8 < live ? 0x0000ffffu : 0u) |
                              (2 * tq + 9 < live ? 0xffff0000u : 0u);
      const int r = 16 * cw + (mat >> 1) * 8 + r_ld;
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        acc[mt][0] *= corr0;
        acc[mt][1] *= corr1;
        acc[mt][2] *= corr0;
        acc[mt][3] *= corr1;
        uint32_t a[4];
        ldsm_x4_trans(a, tile_addr(vbase, r, 2 * mt + (mat & 1)));
        a[0] &= keep01;
        a[1] &= keep01;
        a[2] &= keep89;
        a[3] &= keep89;
        mma_bf16(acc[mt], a, b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }

  // the warp's sums over its token rows, then the block's merge in warp
  // order through shared memory (the ring: every stage has been read)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
  }
  float* s_m = ring_f;                    // [kConsumers][8]
  float* s_l = s_m + kConsumers * 8;      // [kConsumers][8]
  float* s_acc = s_l + kConsumers * 8;    // [kConsumers][G][HD]
  named_barrier(1, 32 * kConsumers);
  if (g == 0) {
    s_m[cw * 8 + 2 * tq] = m[0];
    s_m[cw * 8 + 2 * tq + 1] = m[1];
    s_l[cw * 8 + 2 * tq] = l[0];
    s_l[cw * 8 + 2 * tq + 1] = l[1];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int head = 2 * tq + j;
    if (head < G) {
      float* dst = s_acc + (cw * G + head) * HD + g;
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        dst[16 * mt] = acc[mt][j];
        dst[16 * mt + 8] = acc[mt][2 + j];
      }
    }
  }
  named_barrier(1, 32 * kConsumers);

  const bool direct = nsplit == 1;
  const int64_t item = ((int64_t)b * kvh + h) * nsplit_max;  // this (row, kv head)'s first split
  float* ws_acc = ws + item * G * HD;                          // [B, kvh, splits, G, HD]
  float* ws_ml = ws + (int64_t)gridDim.y * kvh * nsplit_max * G * HD + item * G * 2;  // [.., G, 2]
  for (int e = ct; e < G * HD; e += 32 * kConsumers) {
    const int head = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, s_m[w * 8 + head]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float c = pow2_shift(s_m[w * 8 + head], mx);  // 0: a warp with no tokens
      lt = fmaf(s_l[w * 8 + head], c, lt);
      o = fmaf(s_acc[(w * G + head) * HD + d], c, o);
    }
    if (direct) {
      orow[e] = o / lt;
    } else {
      ws_acc[(int64_t)split * G * HD + e] = o;
      if (d == 0) {
        ws_ml[(split * G + head) * 2] = mx;
        ws_ml[(split * G + head) * 2 + 1] = lt;
      }
    }
  }
  if (direct) return;

  // the last split of this (row, kv head) to arrive merges all of them.
  // One thread's acquire-release arrival, after the block's barrier,
  // publishes the block's partial and, for the last, acquires the others'
  named_barrier(1, 32 * kConsumers);
  if (ct == 0) {
    int* counter = arrivals + (int64_t)b * kvh + h;
    int done;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(counter)
                 : "memory");
    last_flag = done == nsplit - 1;
    if (last_flag) *counter = 0;  // every split has arrived: ready for the next call
  }
  named_barrier(1, 32 * kConsumers);
  if (!last_flag) return;
  // the splits' (max, sum) pairs into shared memory, all loads in flight at
  // once; then each thread sums its float4 of the output over the splits
  // in split order, eight splits' loads in flight at a time
  float2* s_ml = reinterpret_cast<float2*>(ring_f);  // [nsplit][G]
  const float2* ml = reinterpret_cast<const float2*>(ws_ml);
  for (int i = ct; i < nsplit * G; i += 32 * kConsumers) s_ml[i] = __ldcg(ml + i);
  named_barrier(1, 32 * kConsumers);
  constexpr int NV = G * HD / 4;
  const float4* acc4 = reinterpret_cast<const float4*>(ws_acc);
  for (int v = ct; v < NV; v += 32 * kConsumers) {
    const int head = v / (HD / 4);
    float mx = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, s_ml[sp * G + head].x);
    float lt = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {
      const float2 p = s_ml[sp * G + head];
      const float c = pow2_shift(p.x, mx);
      const float4 a = __ldcg(acc4 + (int64_t)sp * NV + v);
      lt = fmaf(p.y, c, lt);
      o.x = fmaf(a.x, c, o.x);
      o.y = fmaf(a.y, c, o.y);
      o.z = fmaf(a.z, c, o.z);
      o.w = fmaf(a.w, c, o.w);
    }
    reinterpret_cast<float4*>(orow)[v] = make_float4(o.x / lt, o.y / lt, o.z / lt, o.w / lt);
  }
}

// ------------------------------------------------------------ host
// Tensor maps over a pool [rows, kvd] (bf16), boxes of [piece rows x 64
// columns], cached by (pointer, rows, kvd, piece): encoding reads no data,
// so a cached map is exact for any pool at that address and shape.
struct MapEntry {
  const void* ptr;
  long long rows;
  int kvd, piece;
  CUtensorMap map;
};

cudaError_t pool_map(CUtensorMap* map, const void* ptr, long long rows, int kvd, int piece) {
  static std::mutex mu;
  static MapEntry cache[16];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const MapEntry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.kvd == kvd && e.piece == piece) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kvd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kvd * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)piece};
  const cudaError_t err = bf16_tensor_map(map, ptr, 2, dims, strides, box);
  if (err != cudaSuccess) return err;
  MapEntry& slot = cache[next];
  slot = MapEntry{ptr, rows, kvd, piece, *map};
  next = (next + 1) % 16;
  used = used < 16 ? used + 1 : 16;
  return cudaSuccess;
}

struct Args {
  const CUtensorMap *mk, *mv;
  const uint16_t* q;
  const int32_t *table, *lengths;
  float *out, *ws;
  int* arrivals;
  int B, kvh, W, bs, piece, layer_row0, split_tokens, nsplit;
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  // every launch: the attribute is the current device's
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<HD>);
  if (attr != cudaSuccess) return attr;
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  paged_decode_kernel<HD, G><<<dim3(a.kvh, a.B, a.nsplit), kThreads, kSmemBytes<HD>, a.stream>>>(
      *a.mk, *a.mv, a.q, a.table, a.lengths, a.out, a.ws, a.arrivals, a.W, a.bs, a.piece,
      a.layer_row0, a.split_tokens, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<HD, 1>(a);
    case 2: return launch<HD, 2>(a);
    case 4: return launch<HD, 4>(a);
    case 8: return launch<HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, nh, hd] bf16; pk/pv [L, NB, bs, kvh*hd] bf16 (layer li is used);
// table [B, W] and lengths [B] int32; out [B, nh*hd] fp32; ws fp32 of at
// least B*kvh*nsplit*group*(hd + 2) floats; arrivals [B*kvh] int32, zero.
// bs a multiple of 8 that divides 64 or is a multiple of 64; split_tokens
// a multiple of 64; nsplit = ceil(W*bs / split_tokens), at most 256;
// L*NB*bs below 2^31.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int paged_decode_attention_bf16(const void* q, const void* pk, const void* pv,
                                           const void* table, const void* lengths, void* out,
                                           void* ws, void* arrivals, int n_layers, int nb,
                                           int li, int B, int nh, int kvh, int hd, int W, int bs,
                                           int split_tokens, int nsplit, void* stream) {
  const long long rows = (long long)n_layers * nb * bs;
  if (B <= 0 || kvh <= 0 || nh % kvh != 0 || W <= 0 || bs <= 0 || bs % 8 != 0 ||
      (64 % bs != 0 && bs % 64 != 0) || split_tokens <= 0 || split_tokens % kStageTokens != 0 ||
      nsplit <= 0 || nsplit > kMaxSplits || B > 65535 ||
      (long long)nsplit * split_tokens < (long long)W * bs || rows >= (1ll << 31) ||
      li < 0 || li >= n_layers) {
    return (int)cudaErrorInvalidValue;
  }
  const int piece = bs < kStageTokens ? bs : kStageTokens;
  const int kvd = kvh * hd;
  CUtensorMap mk, mv;
  cudaError_t err = pool_map(&mk, pk, rows, kvd, piece);
  if (err == cudaSuccess) err = pool_map(&mv, pv, rows, kvd, piece);
  if (err != cudaSuccess) return (int)err;
  const Args a{&mk,
               &mv,
               static_cast<const uint16_t*>(q),
               static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(lengths),
               static_cast<float*>(out),
               static_cast<float*>(ws),
               static_cast<int*>(arrivals),
               B,
               kvh,
               W,
               bs,
               piece,
               li * nb * bs,
               split_tokens,
               nsplit,
               static_cast<cudaStream_t>(stream)};
  const int group = nh / kvh;
  switch (hd) {
    case 64: return (int)dispatch_group<64>(group, a);
    case 128: return (int)dispatch_group<128>(group, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
