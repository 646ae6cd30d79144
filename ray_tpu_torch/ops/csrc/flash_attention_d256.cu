// Flash attention forward and backward for Hopper (sm_90a), bf16 inputs,
// head_dim 256.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/flash_attention.py:_fwd_kernel
// and :_bwd_kernel for bf16 inputs with 256-wide heads (the JAX package's
// gate sends every head_dim that is a multiple of 128 to them).  Layout and
// C entries as flash_attention.cu (head_dim 128): q [B*Hq, S, D], k/v
// [B*Hkv, S, D], contiguous; the kv head of q head bh is bh / n_rep.
//
// What bounds it on the H100: operations.  At [B=8, S=2048, Hq=16, Hkv=8,
// D=256] causal the forward's 2.75e11 flops take 0.278 ms at 989 TFLOP/s
// and its 0.40 GB of inputs and outputs 0.12 ms at 3.35 TB/s; the
// backward's five products 0.695 ms against 0.24 ms of bytes.
//
// The design is flash_attention.cu's (read it first): 128-byte-swizzled
// tiles loaded by TMA into 2-stage mbarrier rings, wgmma with fp32
// accumulators, P and dS in registers as the A operand, V, dO, Q and K read
// MN-major through the transpose bit.  Its tiles do not fit at D = 256: a
// 128-row tile is 64 KB (four 64-column boxes), so the forward's Q and two
// stages of 128-key K and V would take 320 KB of the 227 KB a block may
// have, and a dK/dV warpgroup owning 64 keys would hold 256 accumulator
// registers.  Nor does its producer warpgroup: with a third warpgroup
// ptxas allocates every thread against 168 registers, and under the
// consumers' setmaxnreg raise to 240 it still spilled the accumulators
// around every product and serialized the wgmmas (a WARPGROUP.DEPBAR after
// every HGMMA in the SASS), slower in every kernel than this.  So each
// block is two warpgroups, both computing, one thread of the second also
// issuing the loads, and:
//   - forward: one block per (q head, 128-row q tile), 64 rows per
//     warpgroup, the longest causal tiles first; 64-key K/V tiles, two
//     stages: Q 64 KB + 2 x (32 + 32) KB = 192 KB.  S = Q K^T as m64n64k16
//     over 16 k-steps, O += P V as m64n256k16 over 4 (registers: O 128, S
//     32, P 16); K and V have their own empty barriers.  Issuing the next
//     tile's S under this tile's softmax, or the two warpgroups' S in
//     turns, measured no faster (ptxas serialized the first);
//   - backward, three launches, no atomics (deterministic):
//       delta  rowsum(dO * O) in fp32, 32 threads a row;
//       dK/dV  one block per (kv head, 64-key tile): K and V (32 KB each)
//              loaded once; stages of a 64-row Q and dO tile (32 KB each)
//              with 64 LSE and delta values, two stages: 192 KB.  The first
//              warpgroup forms S^T = K Q^T and P^T, the second dP^T = V
//              dO^T (64 x 64 over 16 k-steps each); they swap the two fp32
//              tiles through 32 KB of shared memory (224 KB in all), and
//              warpgroup c accumulates columns 128c.. of dK and dV (128
//              registers) over the group's n_rep q heads, written once;
//       dQ     one block per (q head, 128-row q tile): Q and dO (64 KB
//              each) loaded once; 64-key K tiles in two stages and V tiles
//              in one (V is free once dP is formed, K only after dQ += dS
//              K): 224 KB.  S and dP as m64n64k16, dQ += dS K as m64n256k16
//              (accumulator 128 registers).  With 32-key tiles in two
//              stages each, S and dP (m64n32, both operands from shared
//              memory) ask for more shared-memory bandwidth per product
//              than an SM has, and the kernel ran slower.
//
// Rounding points: flash_attention.cu's, unchanged (the plain versions
// flash_attention_{fwd,bwd}_reference in ray_tpu_torch/ops/flash_attention.py
// round the same values): fp32 scores scaled by one scale_log2; the softmax
// shift the running log2 max rounded up to an integer (power-of-two
// rescales); P and dS rounded to bf16 before their products; each output
// rounded once from its fp32 sum.  A warpgroup's causal diagonal ends its
// loops: the tiles past it (all of their scores masked) would add zeros.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int D = 256;
// Two warpgroups, both computing; ptxas allocates against the launch
// bound, 65,536 / 256 -> 255 registers a thread (a ninth warp would count
// as a third warpgroup: 168).  The loader, the first thread of the second
// warpgroup (which visits every tile, causal or not), also issues the TMA
// loads, each once the stage it refills is free.
constexpr int kThreads = 256;
constexpr int kLoader = 128;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

// a [rows x 256] tile (four 64-column boxes) by TMA, completing on `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row, int rows) {
#pragma unroll
  for (int b = 0; b < 4; ++b) tma_load_2d(dst + b * rows * 128, map, bar, 64 * b, row);
}

// ---------------------------------------------------------------- forward
// shared: Q [128 x 256]; K and V [64 x 256], two stages each; barriers
constexpr int kFwdSmem = tile_bytes(128) + 4 * tile_bytes(64) + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_d256_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, uint16_t* __restrict__ o,
                      float* __restrict__ lse, int S, int n_rep, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int QT = tile_bytes(128), KT = tile_bytes(64);
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t q_s = base;
  // q_full, k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t bar = base + QT + 4 * KT;
  auto k_s = [&](int s) { return base + QT + KT * s; };
  auto v_s = [&](int s) { return base + QT + KT * (2 + s); };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (3 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (5 + s); };
  auto v_empty = [&](int s) { return bar + 8 * (7 + s); };

  // the tile index is the slow grid dimension: every head's longest causal
  // tiles launch first, the shortest last
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int nk = causal ? 2 * qt + 2 : S / 64;  // 64-key tiles the block loads
  const int c = warpgroup();                    // 64 query rows each
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per warp
      mbar_init(v_empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the loader: tiles below `upto` into the ring, in order, each once
  // both warpgroups are done with the tile two before it
  const bool loader = threadIdx.x == kLoader;
  const int kv_row = (bh / n_rep) * S;
  int next = 0;
  auto refill = [&](int upto) {
    for (; next < upto && next < nk; ++next) {
      const int s = next & 1;
      const uint32_t par = ((next >> 1) & 1) ^ 1;
      if (next >= 2) mbar_wait(k_empty(s), par);
      mbar_expect_tx(k_full(s), KT);
      load_tile(k_s(s), &tm_k, k_full(s), kv_row + next * 64, 64);
      if (next >= 2) mbar_wait(v_empty(s), par);
      mbar_expect_tx(v_full(s), KT);
      load_tile(v_s(s), &tm_v, v_full(s), kv_row + next * 64, 64);
    }
  };
  if (loader) {
    mbar_expect_tx(bar, QT);
    load_tile(q_s, &tm_q, bar, bh * S + qt * 128, 128);
    refill(2);
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = qt * 128 + 64 * c + 16 * warp + g;  // this thread's two rows
  const int row_b = row_a + 8;
  // causal: up to the tile that holds this warpgroup's diagonal (the first
  // warpgroup's rows precede every key of the block's last tile)
  const int my_nk = causal ? 2 * qt + 1 + c : nk;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float sc[32];
  uint32_t pa[4][4];  // P, the P V product's A fragments
  // nothing that writes S, O or P moves in among the products
  auto fence_operands = [&]() {
    fence_regs(sc);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
  };
  mbar_wait(bar, 0);

  for (int kt = 0; kt < my_nk; ++kt) {
    const int s = kt & 1;
    const uint32_t par = (kt >> 1) & 1;
    mbar_wait(k_full(s), par);
    // S = Q K^T
    const uint32_t qa = opaque(q_s), ka = k_s(s);
    fence_operands();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      wgmma_ss_n64(sc, kmajor_desc<128>(qa, 64 * c, kk), kmajor_desc<64>(ka, 0, kk), kk > 0);
    }
    wgmma_commit();
    if (loader) refill(kt + 2);  // tile kt + 1, while S runs
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(s));  // this warp is done with K of stage s

    // scores in log2 units, the causal mask (diagonal tile only), row max;
    // a row of a visited tile keeps at least one key, so the shift is finite
    const bool diag = causal && kt == my_nk - 1;
    auto score = [&](int j, int e) {
      const float x = sc[4 * j + e] * scale_log2;
      return diag && kt * 64 + 8 * j + 2 * t + (e & 1) > (e < 2 ? row_a : row_b) ? -INFINITY : x;
    };
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], score(j, e));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], ceilf(quad_max(mx[i])));
      const float corr = pow2_shift(m[i], m_new);  // 0 on the first tile
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }
    // exponentials: fp32 into the row sums, bf16 into the P V product
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(score(j, e) - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V
    mbar_wait(v_full(s), par);
    const uint32_t va = v_s(s);
    fence_operands();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n256_tb(acc, pa[kk], mnmajor_desc<64>(va, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(v_empty(s));  // and with V of stage s
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<128, D>(o + ((int64_t)bh * S + row_a) * D, acc, t, l[0], l[1]);
  if (t == 0) {
    lse[(int64_t)bh * S + row_a] = (m[0] + log2f(l[0])) * kLn2;
    lse[(int64_t)bh * S + row_b] = (m[1] + log2f(l[1])) * kLn2;
  }
}

// ---------------------------------------------------------- backward: dK, dV
// One block per (kv head, 64-key tile), in the transposed frame: warpgroup
// 0 forms S^T = K Q^T (and P^T), warpgroup 1 dP^T = V dO^T, over the
// tile's 64 keys; they swap them through shared memory, and warpgroup c
// owns columns 128c.. of dK and dV.
// shared: K, V [64 x 256]; per stage Q, dO [64 x 256], 64 LSE and 64
// delta; the two 64 x 64 fp32 tiles swapped
constexpr int kXch = 32 * 128 * 4;  // one warpgroup's 64 x 64 fp32 accumulator
constexpr int kDkdvSmem =
    2 * tile_bytes(64) + 2 * (2 * tile_bytes(64) + 512) + 2 * kXch + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_d256_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, uint16_t* __restrict__ dk,
                       uint16_t* __restrict__ dv, int S, int n_rep, int causal, float scale,
                       float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int T = tile_bytes(64);
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t k_s = base, v_s = base + T;
  auto q_s = [&](int s) { return base + T * (2 + s); };
  auto do_s = [&](int s) { return base + T * (4 + s); };
  const uint32_t vec = base + 6 * T;  // lse[s][64], then delta[s][64]
  auto l_s = [&](int s) { return vec + 256 * s; };
  auto d_s = [&](int s) { return vec + 256 * (2 + s); };
  const uint32_t xch = vec + 1024;  // P^T, then dP^T: [32][128] fp32 each
  const uint32_t bar = xch + 2 * kXch;  // kv_full, full[2], empty[2]
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (3 + s); };
  const float* vec_p = reinterpret_cast<const float*>(smem_raw + (vec - smem_addr(smem_raw)));
  float* xch_p = reinterpret_cast<float*>(smem_raw + (xch - smem_addr(smem_raw)));

  const int kt = blockIdx.y;  // tile 0 has the most causal work: first, for every head
  const int bkv = blockIdx.x;
  const int q_first = causal ? kt : 0;  // 64-row q tiles before it see no key here
  const int per_head = S / 64 - q_first;
  const int n_it = n_rep * per_head;  // (q head, q tile) steps, head-major
  const int c = warpgroup();          // 128 columns of dK and dV each
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the loader: steps below `upto` into the ring, in order, each once both
  // warpgroups are done with the step two before it
  const bool loader = threadIdx.x == kLoader;
  int next = 0;
  auto refill = [&](int upto) {
    for (; next < upto && next < n_it; ++next) {
      const int s = next & 1;
      if (next >= 2) mbar_wait(empty(s), ((next >> 1) & 1) ^ 1);
      const int row = (bkv * n_rep + next / per_head) * S + (q_first + next % per_head) * 64;
      mbar_expect_tx(full(s), 2 * T + 512);
      load_tile(q_s(s), &tm_q, full(s), row, 64);
      load_tile(do_s(s), &tm_do, full(s), row, 64);
      bulk_load(l_s(s), lse + row, 256, full(s));
      bulk_load(d_s(s), delta + row, 256, full(s));
    }
  };
  if (loader) {
    mbar_expect_tx(bar, 2 * T);
    load_tile(k_s, &tm_k, bar, bkv * S + kt * 64, 64);
    load_tile(v_s, &tm_v, bar, bkv * S + kt * 64, 64);
    refill(2);
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = kt * 64 + 16 * warp + g;  // this thread's two keys
  const int key_b = key_a + 8;
  const uint32_t half = 2 * c * (tile_bytes(64) / 4);  // boxes 2c, 2c + 1 of a Q or dO tile
  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(bar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const int qi = q_first + it % per_head;
    mbar_wait(full(s), (it >> 1) & 1);
    // the first warpgroup forms S^T = K Q^T and P^T from the saved LSE,
    // the second dP^T = V dO^T; each hands its 64 x 64 fp32 product to
    // the other through shared memory
    const uint32_t at_ = opaque(c == 0 ? k_s : v_s), bt_ = c == 0 ? q_s(s) : do_s(s);
    float mine[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      wgmma_ss_n64(mine, kmajor_desc<64>(at_, 0, kk), kmajor_desc<64>(bt_, 0, kk), kk > 0);
    }
    wgmma_commit();
    if (loader) refill(it + 2);  // step it + 1, while the product runs
    wgmma_wait<0>();
    fence_regs(mine);
    const bool diag = causal && qi == kt;
    const float* ls = vec_p + 64 * s;
    const float* dl = vec_p + 64 * (2 + s);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float x = mine[4 * j + e] * scale_log2 - ls[qc] * kLog2e;
          if (diag && (e < 2 ? key_a : key_b) > qi * 64 + qc) x = -INFINITY;  // exp2: 0
          mine[4 * j + e] = exp2f(x);
        }
      }
    }
    const int tid = threadIdx.x % 128;
    if (it > 0) named_barrier(2, 256);  // both have read the last exchange
#pragma unroll
    for (int i = 0; i < 32; ++i) xch_p[(32 * c + i) * 128 + tid] = mine[i];
    named_barrier(1, 256);
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float other = xch_p[(32 * (1 - c) + i) * 128 + tid];
      st[i] = c == 0 ? mine[i] : other;
      dpt[i] = c == 0 ? other : mine[i];
    }
    // per half of the 64 q rows: P^T and dS^T = P^T (dP^T - delta) * scale
    // as bf16 fragments, then dV += P^T dO and dK += dS^T Q over this
    // warpgroup's 128 columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t pa[2][4], dsa[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * hh + jj;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = st[4 * j + e] * (dpt[4 * j + e] - dl[8 * j + 2 * t + (e & 1)]) * scale;
        }
        pa[jj / 2][(jj & 1) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
        pa[jj / 2][(jj & 1) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
        dsa[jj / 2][(jj & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[jj / 2][(jj & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_rs_n128_tb(dva, pa[kk], mnmajor_desc<64>(do_s(s) + half, 2 * hh + kk), 1);
        wgmma_rs_n128_tb(dka, dsa[kk], mnmajor_desc<64>(q_s(s) + half, 2 * hh + kk), 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (lane == 0) mbar_arrive(empty(s));
  }
  const int64_t at = ((int64_t)bkv * S + key_a) * D + 128 * c;
  store_rows<64, D>(dk + at, dka, t, 1.f, 1.f);
  store_rows<64, D>(dv + at, dva, t, 1.f, 1.f);
}

// -------------------------------------------------------------- backward: dQ
// One block per (q head, 128-row q tile); warpgroup c owns rows 64c...
// shared: Q, dO [128 x 256]; K [64 x 256] in two stages, V [64 x 256] in
// one (V is free once dP is formed; K feeds dQ += dS K at the end)
constexpr int kDqSmem = 2 * tile_bytes(128) + 3 * tile_bytes(64) + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_d256_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, uint16_t* __restrict__ dq, int S, int n_rep,
                     int causal, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int QT = tile_bytes(128), KT = tile_bytes(64);
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t q_s = base, do_s = base + QT, v_s = base + 2 * QT + 2 * KT;
  auto k_s = [&](int s) { return base + 2 * QT + KT * s; };
  // q_full, k_full[2], k_empty[2], v_full, v_empty
  const uint32_t bar = base + 2 * QT + 3 * KT;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (3 + s); };
  const uint32_t v_full = bar + 40, v_empty = bar + 48;

  // the tile index is the slow grid dimension: every head's longest causal
  // tiles launch first, the shortest last
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int nk = causal ? 2 * qt + 2 : S / 64;  // 64-key tiles the block loads
  const int c = warpgroup();                    // 64 query rows each
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  // the loader: tiles below `upto` in order, K once both warpgroups are
  // done with the tile two before, V with the tile before
  const bool loader = threadIdx.x == kLoader;
  const int kv_row = (bh / n_rep) * S;
  int next = 0;
  auto refill = [&](int upto) {
    for (; next < upto && next < nk; ++next) {
      const int s = next & 1;
      if (next >= 2) mbar_wait(k_empty(s), ((next >> 1) & 1) ^ 1);
      mbar_expect_tx(k_full(s), KT);
      load_tile(k_s(s), &tm_k, k_full(s), kv_row + next * 64, 64);
      if (next >= 1) mbar_wait(v_empty, (next & 1) ^ 1);
      mbar_expect_tx(v_full, KT);
      load_tile(v_s, &tm_v, v_full, kv_row + next * 64, 64);
    }
  };
  if (loader) {
    mbar_expect_tx(bar, 2 * QT);
    load_tile(q_s, &tm_q, bar, bh * S + qt * 128, 128);
    load_tile(do_s, &tm_do, bar, bh * S + qt * 128, 128);
    refill(1);
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = qt * 128 + 64 * c;
  const int row_a = row0 + 16 * warp + g;  // this thread's two rows
  const int row_b = row_a + 8;
  // causal: up to the tile that holds this warpgroup's diagonal (the first
  // warpgroup's rows precede every key of the block's last tile)
  const int my_nk = causal ? 2 * qt + 1 + c : nk;
  const int64_t at = (int64_t)bh * S;
  const float lse_a = lse[at + row_a] * kLog2e, lse_b = lse[at + row_b] * kLog2e;
  const float d_a = delta[at + row_a], d_b = delta[at + row_b];
  float dqa[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dqa[i] = 0.f;
  mbar_wait(bar, 0);

  for (int kt = 0; kt < my_nk; ++kt) {
    const int s = kt & 1;
    mbar_wait(k_full(s), (kt >> 1) & 1);
    mbar_wait(v_full, kt & 1);
    // two wgmma groups: S, then dP; P is formed while dP runs
    const uint32_t qa = opaque(q_s), da = opaque(do_s), ka = k_s(s);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      wgmma_ss_n64(sc, kmajor_desc<128>(qa, 64 * c, kk), kmajor_desc<64>(ka, 0, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      wgmma_ss_n64(dp, kmajor_desc<128>(da, 64 * c, kk), kmajor_desc<64>(v_s, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    const bool diag = causal && kt == my_nk - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * 64 + 8 * j + 2 * t + (e & 1);
        const bool lo = e < 2;
        float x = sc[4 * j + e] * scale_log2 - (lo ? lse_a : lse_b);
        if (diag && col > (lo ? row_a : row_b)) x = -INFINITY;  // exp2: 0
        sc[4 * j + e] = exp2f(x);
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (lane == 0) mbar_arrive(v_empty);  // this warp is done with V
    if (loader) refill(kt + 2);           // tile kt + 1
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = sc[4 * j + e] * (dp[4 * j + e] - (e < 2 ? d_a : d_b)) * scale;
      dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n256_tb(dqa, dsa[kk], mnmajor_desc<64>(ka, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    if (lane == 0) mbar_arrive(k_empty(s));
  }
  store_rows<128, D>(dq + (at + row_a) * D, dqa, t, 1.f, 1.f);
}

}  // namespace

// The entries of flash_attention.cu, at head_dim 256.  q [bhq, S, D], k/v
// [bhkv, S, D] bf16; o [bhq, S, D] bf16 and lse [bhq, S] fp32 out.
// scale_log2 = softmax scale * log2(e).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bhq, int bhkv, int S, int D_, int causal,
                                        float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S, D_, D)) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  RETURN_IF_ERROR(allow_smem(flash_d256_fwd_kernel, kFwdSmem, ready));
  CUtensorMap mq, mk, mv;
  RETURN_IF_ERROR(tile_map<D>(&mq, q, (int64_t)bhq * S, 128));
  RETURN_IF_ERROR(tile_map<D>(&mk, k, (int64_t)bhkv * S, 64));
  RETURN_IF_ERROR(tile_map<D>(&mv, v, (int64_t)bhkv * S, 64));
  flash_d256_fwd_kernel<<<dim3(bhq, S / 128), kThreads, kFwdSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), static_cast<float*>(lse), S, bhq / bhkv, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

// Adds o and dout [bhq, S, D] bf16 and the forward's lse [bhq, S]; delta
// [bhq, S] fp32 is scratch; dq [bhq, S, D], dk/dv [bhkv, S, D] bf16 out.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int bhq,
                                        int bhkv, int S, int D_, int causal, float scale,
                                        float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S, D_, D)) return (int)cudaErrorInvalidValue;
  static bool dkdv_ready = false, dq_ready = false;
  RETURN_IF_ERROR(allow_smem(flash_d256_dkdv_kernel, kDkdvSmem, dkdv_ready));
  RETURN_IF_ERROR(allow_smem(flash_d256_dq_kernel, kDqSmem, dq_ready));
  const int64_t rows_q = (int64_t)bhq * S, rows_kv = (int64_t)bhkv * S;
  CUtensorMap q64, do64, k64, v64, q128, do128;
  RETURN_IF_ERROR(tile_map<D>(&q64, q, rows_q, 64));
  RETURN_IF_ERROR(tile_map<D>(&do64, dout, rows_q, 64));
  RETURN_IF_ERROR(tile_map<D>(&k64, k, rows_kv, 64));
  RETURN_IF_ERROR(tile_map<D>(&v64, v, rows_kv, 64));
  RETURN_IF_ERROR(tile_map<D>(&q128, q, rows_q, 128));
  RETURN_IF_ERROR(tile_map<D>(&do128, dout, rows_q, 128));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  const int n_rep = bhq / bhkv;
  flash_bwd_delta_kernel<D><<<(unsigned)(rows_q / 8), 256, 0, st>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout), d);
  RETURN_IF_ERROR(cudaGetLastError());
  flash_d256_dkdv_kernel<<<dim3(bhkv, S / 64), kThreads, kDkdvSmem, st>>>(
      q64, k64, v64, do64, l, d, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), S,
      n_rep, causal, scale, scale_log2);
  RETURN_IF_ERROR(cudaGetLastError());
  flash_d256_dq_kernel<<<dim3(bhq, S / 128), kThreads, kDqSmem, st>>>(
      q128, k64, v64, do128, l, d, static_cast<uint16_t*>(dq), S, n_rep, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
