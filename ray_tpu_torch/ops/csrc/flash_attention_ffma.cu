// Flash attention forward and backward for Hopper (sm_90a) in fp32, at
// head_dim 128 and 256: the inputs the wgmma pairs (flash_attention.cu and
// flash_attention_d256.cu, bf16 at head_dim 128 and 256) do not take.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/flash_attention.py:_fwd_kernel
// and :_bwd_kernel for those inputs: the JAX package's gate sends any S and D
// that are multiples of 128 to them, in any dtype (Llama-3-8B and Mixtral at
// compute_dtype=float32).  Layout as the TPU wrappers: q [B*Hq, S, D], k/v
// [B*Hkv, S, D], contiguous; the kv head of q head bh is bh / n_rep.
//
// What bounds it on the H100: operations.  At [B=8, S=2048, Hq=16, Hkv=8,
// D=256] causal in fp32, the forward's 2.75e11 flops take 4.1 ms at the
// 67 TFLOP/s fp32 peak (FFMA: fp32 stays fp32, no TF32), its 0.81 GB of
// inputs and outputs 0.24 ms at 3.35 TB/s; the backward's five products
// 10.3 ms.  An SM issues four FFMA warp-instructions a clock but serves one
// shared-memory wavefront a clock, so a product fed by 4-byte loads from
// shared memory runs at the loads' rate, not the FFMA rate.
//
// Both directions are designed for the FFMA pipes: register tiles read as
// float4 (16-byte loads), the streamed tiles two stages deep through
// cp.async, no spills.  The forward: one block per (q head, q tile of 128
// rows at D = 128, 64 at D = 256), 32-key tiles up to the causal diagonal;
// 8 x 8 score and O tiles a thread, 4 FFMA per float loaded in both
// products; online softmax in log2 units with the running max rounded UP to
// an integer (every rescale an exact power of two); exponentials summed
// unrounded into l and into the PV product (flash_attention.cu's algorithm,
// every rounding point a no-op at fp32).  Shared memory 154 KB at D = 128,
// 209 KB at D = 256; one block per SM.
//
// The backward: 2.7-4 FFMA per float loaded.  Four launches, no atomics, the
// same bits from the same inputs: delta = rowsum(dO * O); dK/dV, one block
// per (q head, key tile), each q head's share summed in fp32 over 32-row q
// tiles from the diagonal on; when a kv head serves n_rep > 1 q heads, the
// q heads' shares are written to scratch and a fourth pass sums each group
// in q-head order (n_rep times the blocks of a block per kv head); dQ, one
// block per (q head, q tile) over 32-key tiles up to the diagonal
// (recomputing S and dP: seven products where the bound counts five).
// Tiles: 64 keys or q rows resident at D = 128, 32 at D = 256; 256 threads;
// shared memory 151 KB at D = 128, 205 KB at D = 256; one block per SM.
// Plain version: flash_attention_{fwd,bwd}_reference in
// ray_tpu_torch/ops/flash_attention.py.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeqMultiple = 128;  // the forward's q tiles, the backward's tiles
constexpr int BK = 32;  // keys of a tile
constexpr int kBN = 32;  // streamed rows of a backward tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------- backward
// delta = rowsum(dO * O) in fp32: one warp per row
template <int D>
__global__ void __launch_bounds__(kThreads) ffma_delta_kernel(const float* __restrict__ o,
                                                              const float* __restrict__ dout,
                                                              float* __restrict__ delta,
                                                              int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float x = 0.f;
  for (int d = lane; d < D; d += 32) x = fmaf(dout[row * D + d], o[row * D + d], x);
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) delta[row] = x;
}

// dK/dV and dQ: one kernel body, two roles.  A block keeps BM rows of two
// [*, D] arrays resident (dK/dV: a key tile's K and V; dQ: a query tile's Q
// and dO) and streams 32-row tiles of the other two (dK/dV: the q head's Q
// and dO from the diagonal on; dQ: the kv head's K and V up to it), two
// stages deep through cp.async, so the next tile lands while this one is
// multiplied.  Two barriers a tile.
//
// Shared memory serves 128 bytes a clock to an SM's four FFMA pipes, which
// take 128 fp32 multiply-adds a clock: a product runs at the FFMA rate only
// where a thread does 4 FFMA per float it loads from shared memory
// (broadcast does not help: a warp's 16-byte load delivers 512 bytes).
// Hence register tiles read as float4:
//   1. the scores X1 = A1 B1^T and X2 = A2 B2^T [BM x 32] (dK/dV: S^T and
//      dP^T; dQ: S and dP): each thread a 4 x 8 tile of both, rows RG
//      apart and columns 4 apart, over every F-th float4 of D (F = D / 32
//      lanes of a warp share a tile): per float4, 12 16-byte loads feed 128
//      FFMA a product (2.7 per float).  The F lanes' sums meet by a
//      reduce-scatter of shuffles, each lane keeping 32 / F elements' S and
//      dP summed over all of D, in a fixed order;
//   2. from them, P = exp2(X1 * scale_log2 - LSE_log2) (0 above the causal
//      diagonal) and dS = P (X2 - delta) * scale, into shared memory;
//   3. the gradient products: dK/dV: dV += P^T dO (threads 0-127) and
//      dK += dS^T Q (threads 128-255), each thread an 8 x 8 tile in
//      registers: per four streamed rows, 8 float4 loads of P or dS and 8
//      of the streamed tile feed 256 FFMA (4 per float); dQ += dS K, each
//      thread a 4 x 8 tile (2.7 per float).
// Rows sit in shared memory padded to D + 4 floats: 16-byte aligned, and
// rows 1 apart fall 16 bytes apart in the banks; the F lanes of a tile read
// interleaved float4s, so each quarter-warp's loads fall in 8 distinct
// 16-byte bank groups.
template <int D>
struct Bwd {
  static constexpr int BM = D == 128 ? 64 : 32;  // resident rows
  static constexpr int LD = D + 4;               // a row in shared memory (floats)
  static constexpr int F = D / 32;               // lanes sharing a score tile
  static constexpr int RG = BM / 4;              // score rows of a tile: RG apart
  static constexpr int WN = D / 64;              // warps across D in dQ's step 3
  static constexpr int LDP = kBN + 4;            // a row of P or dS
  // shared memory, in floats: the resident rows [2][BM][LD]; two stages of
  // two streamed tiles [2][kBN][LD] and their rows' LSE and delta [2][kBN]
  // (dK/dV); P and dS [2][BM][LDP]; the resident rows' LSE (log2 units) and
  // delta [2][BM] (dQ)
  static constexpr int kStage = 2 * BM * LD;
  static constexpr int kStageSize = 2 * kBN * LD + 2 * kBN;
  static constexpr int kPd = kStage + 2 * kStageSize;
  static constexpr int kRow = kPd + 2 * BM * LDP;
  static constexpr int kFloats = kRow + 2 * BM;
  static_assert(kFloats * 4 <= 232448, "over the 227 KB a block may take");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until none of this thread's copy groups is still in flight
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, rows) of a [*, D] array at src into shared rows of D + 4 floats
template <int D>
__device__ __forceinline__ void async_rows(float* dst, const float* src, int rows) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < rows * C; i += kThreads)
    cp_async16(dst + (i / C) * (D + 4) + 4 * (i % C), src + (int64_t)(i / C) * D + 4 * (i % C));
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, x))));
}
__device__ __forceinline__ float lane4(float4 a, int s) {
  return s == 0 ? a.x : s == 1 ? a.y : s == 2 ? a.z : a.w;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// one level of the score tiles' reduce-scatter: of x[0, 2 HALF), the lanes
// with `upper` keep the upper half, the others the lower, each adding its
// partner's (lane ^ mask) partial of the half it keeps into x[0, HALF)
template <int HALF>
__device__ __forceinline__ void reduce_half(float (&x)[64], bool upper, int mask) {
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float send = upper ? x[e] : x[e + HALF];
    const float keep = upper ? x[e + HALF] : x[e];
    x[e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// KV: one block per (q head, BM-key tile); out0/out1 = dK/dV of that head
// (the kv head's own at n_rep 1, else a per-q-head partial).  !KV: one block
// per (q head, BM-row q tile), longest causal tiles first; out0 = dQ.
template <int D, bool KV>
__global__ void __launch_bounds__(kThreads, 1) ffma_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ out0, float* __restrict__ out1, int S, int n_rep, int causal, float scale,
    float scale_log2) {
  using T = Bwd<D>;
  constexpr int BM = T::BM, LD = T::LD, F = T::F, RG = T::RG, LDP = T::LDP;
  extern __shared__ __align__(16) float sm[];
  float* res1 = sm;
  float* res2 = res1 + BM * LD;
  float* pd = sm + T::kPd;
  float* rowv = sm + T::kRow;
  const int tid = threadIdx.x, h = blockIdx.x;
  const int tile = KV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int64_t q_row0 = (int64_t)h * S, kv_row0 = (int64_t)(h / n_rep) * S;
  const int64_t res_row0 = (KV ? kv_row0 : q_row0) + (int64_t)tile * BM;
  const int64_t str_row0 = KV ? q_row0 : kv_row0;
  const float* b1 = KV ? q : k;
  const float* b2 = KV ? dout : v;
  async_rows<D>(res1, (KV ? k : q) + res_row0 * D, BM);
  async_rows<D>(res2, (KV ? v : dout) + res_row0 * D, BM);
  if (!KV && tid < BM) {
    rowv[tid] = lse[res_row0 + tid] * kLog2e;
    rowv[BM + tid] = delta[res_row0 + tid];
  }
  const int it0 = KV && causal ? tile * BM / kBN : 0;
  const int it1 = !KV && causal ? (tile + 1) * BM / kBN : S / kBN;
  auto load_stage = [&](int it) {
    float* st = sm + T::kStage + (it & 1) * T::kStageSize;
    const int64_t r0 = str_row0 + (int64_t)it * kBN;
    async_rows<D>(st, b1 + r0 * D, kBN);
    async_rows<D>(st + kBN * LD, b2 + r0 * D, kBN);
    if (KV && tid < 16)  // the streamed queries' LSE and delta
      cp_async16(st + 2 * kBN * LD + (tid >> 3) * kBN + 4 * (tid & 7),
                 (tid < 8 ? lse : delta) + r0 + 4 * (tid & 7));
    cp_async_commit();
  };
  load_stage(it0);  // in the resident rows' copy group

  const int w = tid >> 5, lane = tid & 31;
  // step 1: the tile of rows rg + RG i (i < 4) and columns cg + 4 j (j < 8),
  // float4s fq, fq + F, ... of D; the lanes of a quarter-warp read rows 4 or
  // 0 apart (D 128: two tiles, rows rg and rg + 4) and 8 distinct float4s
  const int fq = lane & (F - 1), cg = lane >> 3;
  const int rg = D == 128 ? (w & 3) + 8 * (w >> 2) + 4 * ((lane >> 2) & 1) : w;
  // step 2: this lane's 32 / F elements, e0 + u (u < 32 / F), e = 8 i + j
  int e0 = 0;
#pragma unroll
  for (int bit = 1; bit < F; bit <<= 1) e0 += fq & bit ? 16 / bit : 0;
  // step 3: a thread's gradient rows gr0 + GS i (i < RI) and float4 column
  // chunks gc0 + CS t (t < 2).  dK/dV: threads 0-127 form dV (from P and
  // dO), 128-255 dK (from dS and Q), an 8 x 8 tile each; dQ: 4 x 8
  constexpr int RI = KV ? 8 : 4, GS = KV ? 1024 / D : 4, CS = KV ? D / 8 : 8;
  const int sel = KV ? tid >> 7 : 1;  // 0: P and dO; 1: dS and Q (dK) or K (dQ)
  const int gr0 = KV ? ((w & 3) / (D / 64)) * 4 + (lane >> 3) : (w / T::WN) * 16 + (lane >> 3);
  const int gc0 = KV ? ((w & 3) % (D / 64)) * 8 + (lane & 7) : (w % T::WN) * 16 + (lane & 7);
  float4 acc[RI][2];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t) acc[i][t] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = it0; it < it1; ++it) {
    cp_async_wait_all();
    // this tile (and, first, the resident rows) landed for every thread, and
    // every thread is done with the last tile: its stage and P/dS are free
    __syncthreads();
    if (it + 1 < it1) load_stage(it + 1);
    const float* sb1 = sm + T::kStage + (it & 1) * T::kStageSize;
    const float* sb2 = sb1 + kBN * LD;
    const float* srow = sb2 + kBN * LD;
    {
      float x[64];  // (i, j, product): element (i, j) of X1 at 2 (8 i + j), of X2 after it
#pragma unroll
      for (int e = 0; e < 64; ++e) x[e] = 0.f;
      const float* a1 = res1 + rg * LD + 4 * fq;
      const float* a2 = res2 + rg * LD + 4 * fq;
      const float* r1 = sb1 + cg * LD + 4 * fq;
      const float* r2 = sb2 + cg * LD + 4 * fq;
#pragma unroll
      for (int d = 0; d < D; d += 4 * F) {
        float4 a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(a1 + RG * i * LD + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ld4(r1 + 4 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) x[2 * (8 * i + j)] = dot4(a[i], b[j], x[2 * (8 * i + j)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(a2 + RG * i * LD + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ld4(r2 + 4 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            x[2 * (8 * i + j) + 1] = dot4(a[i], b[j], x[2 * (8 * i + j) + 1]);
      }
      // reduce-scatter over the F lanes
      reduce_half<32>(x, fq & 1, 1);
      reduce_half<16>(x, fq & 2, 2);
      if (F == 8) reduce_half<8>(x, fq & 4, 4);
      // step 2: (m, n) = (key, query) for dK/dV, (query, key) for dQ
#pragma unroll
      for (int u = 0; u < 32 / F; ++u) {
        const int e = e0 + u;
        const int m = rg + RG * (e >> 3), n = cg + 4 * (e & 7);
        const int key = KV ? tile * BM + m : it * kBN + n;
        const int qi = KV ? it * kBN + n : tile * BM + m;
        const float l2 = KV ? srow[n] * kLog2e : rowv[m];
        const float dl = KV ? srow[kBN + n] : rowv[BM + m];
        float xs = x[2 * u] * scale_log2 - l2;
        if (causal && key > qi) xs = -INFINITY;  // exp2: 0
        const float p = exp2f(xs);
        pd[m * LDP + n] = p;
        pd[(BM + m) * LDP + n] = p * (x[2 * u + 1] - dl) * scale;
      }
    }
    __syncthreads();
    // step 3: over the tile's kBN streamed rows, four at a time
    const float* pa = pd + (sel * BM + gr0) * LDP;  // P or dS
    const float* sb = sel ? sb1 : sb2;              // Q or K, or dO
#pragma unroll
    for (int n4 = 0; n4 < kBN; n4 += 4) {
      float4 a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = ld4(pa + GS * i * LDP + n4);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* rb = sb + (n4 + s) * LD + 4 * gc0;
        const float4 b[2] = {ld4(rb), ld4(rb + 4 * CS)};
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float x = lane4(a[i], s);
#pragma unroll
          for (int t = 0; t < 2; ++t) fma4(acc[i][t], x, b[t]);
        }
      }
    }
  }
  float* out = sel ? out0 : out1;  // dK or dQ; dV
  const int64_t o_row0 = (int64_t)h * S + (int64_t)tile * BM + gr0;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      *reinterpret_cast<float4*>(out + (o_row0 + GS * i) * D + 4 * (gc0 + CS * t)) = acc[i][t];
}

// dK and dV of each kv head: its group's n_rep per-q-head partials [bhq, S,
// D] summed in q-head order (blockIdx.y: 0 dK, 1 dV); head4 = S * D / 4
__global__ void __launch_bounds__(kThreads) ffma_group_sum_kernel(
    const float4* __restrict__ part_k, const float4* __restrict__ part_v, float4* __restrict__ dk,
    float4* __restrict__ dv, int64_t head4, int64_t n4, int n_rep) {
  const float4* part = blockIdx.y ? part_v : part_k;
  float4* out = blockIdx.y ? dv : dk;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kThreads) {
    const float4* src = part + (i / head4) * n_rep * head4 + i % head4;
    float4 a = src[0];
    for (int r = 1; r < n_rep; ++r) {
      const float4 b = src[r * head4];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    out[i] = a;
  }
}

// ---------------------------------------------------------------- forward
// One block per (q head, BQ-row q tile), the longest causal tiles first: Q
// lands once, then 32-key tiles of K and V stream two stages deep through
// cp.async up to the causal diagonal, one wait and one barrier a tile.  Per
// tile, both products read their register tiles as float4 (4 FFMA per float
// loaded from shared memory, where 4-byte operands gave 1.8-1.9):
//   1. S = Q K^T [BQ x 32]: each thread an 8 x 8 tile (8 q rows, 8 keys)
//      over every F-th float4 of D (F = D / 32 lanes share a tile): per
//      float4, 8 loads of K and 8 of Q feed 256 FFMA.  The F lanes' sums
//      meet in the backward's fixed-order reduce-scatter; a lane keeps 8 / F
//      rows' 8 keys;
//   2. the online softmax in log2 units, the running max rounded up to an
//      integer (every rescale an exact power of two): the row max over the
//      four lanes that hold a row's 32 keys, P into shared memory, each
//      row's rescale beside it;
//   3. O += P V: each thread an 8 x 8 tile of O (8 rows, two float4 columns)
//      in registers: per four keys, 8 loads of P and 8 of V feed 256 FFMA.
// A warp's score rows are the rows of its O tiles, so P and the rescales
// pass between a warp's own lanes (__syncwarp).  The exponentials are summed
// unrounded into l (per lane, over the four lanes at the end) and into O.
template <int D>
struct Fwd {
  static constexpr int BQ = D == 128 ? 128 : 64;  // query rows of a block
  static constexpr int F = D / 32;                // lanes sharing a score tile
  static constexpr int NR = 8 / F;                // score rows a lane keeps
  static constexpr int CL = D / 8;                // lanes across a row of O
  static constexpr int LD = D + 4;                // a row in shared memory (floats)
  static constexpr int LDP = BK + 4;              // a row of P
  // shared memory, in floats: Q [BQ][LD]; two stages of K and V
  // [2][2][BK][LD]; P [BQ][LDP]; each row's rescale, then its l [BQ]
  static constexpr int kStage = BQ * LD;
  static constexpr int kStageSize = 2 * BK * LD;
  static constexpr int kP = kStage + 2 * kStageSize;
  static constexpr int kRow = kP + BQ * LDP;
  static constexpr int kFloats = kRow + BQ;
  static_assert(kFloats * 4 <= 232448, "over the 227 KB a block may take");
  // the block row of a warp's score-tile row i (i < 8).  D 256: warp w holds
  // rows 8 w + i.  D 128: 16 w + 4 h + i / 2 + 8 (i % 2), h = bit 2 of the
  // lane, so the two 4-lane tiles of a quarter-warp read Q rows 4 apart
  // (64 bytes apart in the banks) and write P rows 8 distinct bank groups
  __device__ __forceinline__ static int row(int w, int lane, int i) {
    return D == 256 ? 8 * w + i : 16 * w + 4 * ((lane >> 2) & 1) + (i >> 1) + 8 * (i & 1);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) ffma_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int n_rep, int causal,
    float scale_log2) {
  using T = Fwd<D>;
  constexpr int BQ = T::BQ, F = T::F, NR = T::NR, CL = T::CL, LD = T::LD, LDP = T::LDP;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ps = sm + T::kP;
  float* rowv = sm + T::kRow;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int64_t q_row0 = (int64_t)bh * S + (int64_t)qt * BQ;
  const int64_t kv_row0 = (int64_t)(bh / n_rep) * S;
  const int n_kt = causal ? (qt + 1) * (BQ / BK) : S / BK;
  auto load_stage = [&](int kt) {
    float* st = sm + T::kStage + (kt & 1) * T::kStageSize;
    const int64_t r0 = kv_row0 + (int64_t)kt * BK;
    async_rows<D>(st, k + r0 * D, BK);
    async_rows<D>(st + BK * LD, v + r0 * D, BK);
    cp_async_commit();
  };
  async_rows<D>(qs, q + q_row0 * D, BQ);
  load_stage(0);  // in Q's copy group

  // step 1: float4s fq, fq + F, ... of D; keys cg * 8 + j (j < 8)
  const int fq = lane & (F - 1), cg = lane >> 3;
  // step 2: after the reduce-scatter, rows i0 + u (u < NR), keys j < 8
  int i0 = 0;
#pragma unroll
  for (int bit = 1; bit < F; bit <<= 1) i0 += fq & bit ? 4 / bit : 0;
  float m[NR], l[NR];
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
  }
  // step 3: rows pr0 + i (i < 8), float4 columns c0 and c0 + CL
  const int pr0 = (BQ / 8) * w + 8 * (lane / CL), c0 = lane % CL;
  float4 acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t) acc[i][t] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    // this tile (and, first, Q) landed for every thread, and every thread
    // is done with the last tile: its stage is free
    __syncthreads();
    if (kt + 1 < n_kt) load_stage(kt + 1);
    const float* ks = sm + T::kStage + (kt & 1) * T::kStageSize;
    const float* vs = ks + BK * LD;
    {
      float x[64];  // element (i, j) at 8 i + j
#pragma unroll
      for (int e = 0; e < 64; ++e) x[e] = 0.f;
      const float* kb = ks + cg * 8 * LD + 4 * fq;
#pragma unroll
      for (int d = 0; d < D; d += 4 * F) {
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ld4(kb + j * LD + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(qs + T::row(w, lane, i) * LD + 4 * fq + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) x[8 * i + j] = dot4(a, b[j], x[8 * i + j]);
        }
      }
      // reduce-scatter over the F lanes: this lane keeps x[0, 8 NR)
      reduce_half<32>(x, fq & 1, 1);
      reduce_half<16>(x, fq & 2, 2);
      if (F == 8) reduce_half<8>(x, fq & 4, 4);
      // step 2
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        const int r = T::row(w, lane, i0 + u);
        const int qi = qt * BQ + r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = x[8 * u + j] * scale_log2;
          if (causal && kt * BK + cg * 8 + j > qi) s = -INFINITY;  // exp2: 0
          x[8 * u + j] = s;
          mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        // a row fully masked in this tile keeps its max: its first tile had key 0
        const float m_new = fmaxf(m[u], ceilf(mx));
        const float alpha = exp2f(m[u] - m_new);
        m[u] = m_new;
        float sum = 0.f, p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = exp2f(x[8 * u + j] - m_new);
          sum += p[j];
        }
        l[u] = l[u] * alpha + sum;  // this lane's keys; summed over lanes at the end
        float* pw = ps + r * LDP + cg * 8;
        *reinterpret_cast<float4*>(pw) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(pw + 4) = make_float4(p[4], p[5], p[6], p[7]);
        if (cg == 0) rowv[r] = alpha;
      }
    }
    __syncwarp();  // this warp's P and rescales are written
    // step 3
    float4 al[2] = {ld4(rowv + pr0), ld4(rowv + pr0 + 4)};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = lane4(al[i >> 2], i & 3);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        acc[i][t].x *= a;
        acc[i][t].y *= a;
        acc[i][t].z *= a;
        acc[i][t].w *= a;
      }
    }
    const float* pa = ps + pr0 * LDP;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ld4(pa + i * LDP + k4);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* vr = vs + (k4 + s) * LD + 4 * c0;
        const float4 b[2] = {ld4(vr), ld4(vr + 4 * CL)};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = lane4(a[i], s);
#pragma unroll
          for (int t = 0; t < 2; ++t) fma4(acc[i][t], x, b[t]);
        }
      }
    }
  }
  __syncwarp();  // this warp is done with its last rescales
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    float lt = l[u];
    lt += __shfl_xor_sync(0xffffffffu, lt, 8);
    lt += __shfl_xor_sync(0xffffffffu, lt, 16);
    const int r = T::row(w, lane, i0 + u);
    if (cg == 0) {
      rowv[r] = lt;
      lse[q_row0 + r] = (m[u] + log2f(lt)) * kLn2;
    }
  }
  __syncwarp();
  const float4 lv[2] = {ld4(rowv + pr0), ld4(rowv + pr0 + 4)};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float li = lane4(lv[i >> 2], i & 3);
    float* orow = o + (q_row0 + pr0 + i) * D + 4 * c0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float4 a = acc[i][t];
      *reinterpret_cast<float4*>(orow + 4 * CL * t) =
          make_float4(a.x / li, a.y / li, a.z / li, a.w / li);
    }
  }
}

// ------------------------------------------------------------------- host
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

#define RETURN_IF_ERROR(x)                  \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bhq, int bhkv, int S,
        int causal, float scale_log2, cudaStream_t st) {
  constexpr int smem = Fwd<D>::kFloats * 4;
  RETURN_IF_ERROR(allow_smem(ffma_fwd_kernel<D>, smem));
  ffma_fwd_kernel<D><<<dim3(bhq, S / Fwd<D>::BQ), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, bhq / bhkv, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* scratch, void* dq, void* dk, void* dv, int bhq, int bhkv, int S,
        int causal, float scale, float scale_log2, cudaStream_t st) {
  constexpr int smem = Bwd<D>::kFloats * 4;
  RETURN_IF_ERROR(allow_smem(ffma_bwd_kernel<D, true>, smem));
  RETURN_IF_ERROR(allow_smem(ffma_bwd_kernel<D, false>, smem));
  const int64_t rows = (int64_t)bhq * S;
  const int n_rep = bhq / bhkv;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* gg = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(scratch);  // delta, then the dK/dV partials
  float* part_k = n_rep > 1 ? d + rows : static_cast<float*>(dk);
  float* part_v = n_rep > 1 ? part_k + rows * D : static_cast<float*>(dv);
  ffma_delta_kernel<D><<<(unsigned)((rows + 7) / 8), kThreads, 0, st>>>(
      static_cast<const float*>(o), gg, d, rows);
  RETURN_IF_ERROR(cudaGetLastError());
  const dim3 grid(bhq, S / Bwd<D>::BM);
  ffma_bwd_kernel<D, true><<<grid, kThreads, smem, st>>>(qq, kk, vv, gg, l, d, part_k, part_v, S,
                                                         n_rep, causal, scale, scale_log2);
  RETURN_IF_ERROR(cudaGetLastError());
  if (n_rep > 1) {
    const int64_t head4 = (int64_t)S * D / 4, n4 = (int64_t)bhkv * head4;
    const unsigned blocks = (unsigned)(n4 < 1024 * kThreads ? (n4 + kThreads - 1) / kThreads : 1024);
    ffma_group_sum_kernel<<<dim3(blocks, 2), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(part_k), reinterpret_cast<const float4*>(part_v),
        static_cast<float4*>(dk), static_cast<float4*>(dv), head4, n4, n_rep);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  ffma_bwd_kernel<D, false><<<grid, kThreads, smem, st>>>(
      qq, kk, vv, gg, l, d, static_cast<float*>(dq), nullptr, S, n_rep, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

bool bad_shape(int bhq, int bhkv, int S) {
  return bhq <= 0 || bhkv <= 0 || bhq % bhkv != 0 || S <= 0 || S % kSeqMultiple != 0;
}

}  // namespace

// fp32 q [bhq, S, D], k/v [bhkv, S, D]; o [bhq, S, D] fp32 and lse [bhq, S]
// fp32 out; D 128 or 256.  Returns the cudaError_t of the launch.
extern "C" int flash_ffma_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bhq, int bhkv, int S, int D, int causal, float scale_log2,
                              void* stream) {
  if (bad_shape(bhq, bhkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return fwd<128>(q, k, v, o, lse, bhq, bhkv, S, causal, scale_log2, st);
  if (D == 256) return fwd<256>(q, k, v, o, lse, bhq, bhkv, S, causal, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

// Adds o and dout [bhq, S, D] and the forward's lse [bhq, S]; `delta` is
// fp32 scratch of bhq * S floats (delta itself) and, when bhq > bhkv,
// 2 * bhq * S * D more (the per-q-head dK/dV partials); dq [bhq, S, D],
// dk/dv [bhkv, S, D] out; all fp32.
extern "C" int flash_ffma_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq, void* dk,
                              void* dv, int bhq, int bhkv, int S, int D, int causal, float scale,
                              float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, bhkv, S, causal, scale,
                    scale_log2, st);
  if (D == 256)
    return bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, bhkv, S, causal, scale,
                    scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
