// Flash attention forward and backward for Hopper (sm_90a), bf16 inputs,
// head_dim 128.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/flash_attention.py:_fwd_kernel
// (forward: O and the log-sum-exp) and :_bwd_kernel (dQ, dK, dV from the
// saved LSE).  Layout as the TPU wrappers: q [B*Hq, S, D], k/v [B*Hkv, S, D],
// contiguous; the kv head of q head bh is bh / n_rep.
//
// What bounds it on the H100: operations.  At the training shapes (B=8,
// S=2048, Hq=16, D=128, causal) the forward does 4*B*Hq*D*S(S+1)/2 =
// 1.375e11 flops on 0.2 GB of inputs and outputs, the backward five
// products (2.5x that) on 0.4 GB: both sit far above the ~295 flops/byte
// where bf16 tensor cores, not HBM, become the limit.  So the design is the
// one that feeds Hopper's tensor cores at their rate:
//   - wgmma (hopper.cuh): 64-row products issued by a warpgroup, B and,
//     where it is an input tile, A read from shared memory through
//     descriptors; where A is a softmax output (P, dS) it stays in
//     registers, and the operand that product reads transposed (V, dO, Q,
//     K) is read MN-major by the transpose bit, never copied;
//   - TMA: one thread of a producer warpgroup loads whole 128-byte-swizzled
//     tiles into a 2-stage ring with full/empty mbarriers, so copies run
//     under the products; the producer gives its registers to the two
//     consumer warpgroups (setmaxnreg);
//   - tiles of 128 queries (forward, dQ) or 128 keys (dK/dV), 64 rows per
//     consumer warpgroup, so each loaded tile feeds two 64-row products;
//   - registers: a dK/dV consumer holds 128 accumulator registers (dK, dV)
//     and 64 more for S^T and dP^T.  The causal mask therefore sets a
//     score's exponent to -inf (exp2 gives 0) instead of branching around
//     the exponential, the warpgroup index is made warp-uniform so the
//     descriptors stay in uniform registers, and P^T / dS^T go to the dV /
//     dK products in two halves: without these ptxas spills the
//     accumulators around every product.
//
// Not the TPU design.  The TPU kernel keeps a whole sequence's K and V in
// VMEM, and its backward accumulates dK/dV in output blocks that the
// sequential Pallas grid revisits across q-blocks and across the n_rep q
// heads of a kv head.  Hopper blocks run in parallel and in no order, so:
//   - forward: one block per (q head, 128-row q tile), the longest causal
//     tiles of every head first; 128-key K/V tiles stream up to the causal
//     diagonal; fp32 online softmax in registers;
//   - backward, three launches, no atomics (deterministic):
//       delta  rowsum(dO * O) in fp32, 16-byte loads;
//       dK/dV  one block per (kv head, 128-key tile): K and V loaded once;
//              the block loops over the n_rep q heads of its group and over
//              64-row q tiles from the diagonal to the end, each stage
//              bringing Q, dO and 64 LSE and delta values; dK and dV summed
//              over the group in registers and written once;
//       dQ     one block per (q head, 128-row q tile): Q and dO loaded
//              once, 64-key K/V tiles stream up to the diagonal.  It
//              recomputes S and dP, which the dK/dV kernel already formed:
//              seven products where five would do, the price of writing dQ
//              without atomics.
//
// Rounding points (plain version: flash_attention_{fwd,bwd}_reference in
// ray_tpu_torch/ops/flash_attention.py rounds the same values):
//   - forward: fp32 scores scaled by the same fp32 scale_log2; the softmax
//     shift is the running max in log2 units rounded UP to an integer, so
//     every rescale is an exact power of two that moves no bf16 rounding
//     (the plain version shifts by the row's max rounded up once);
//     exponentials summed unrounded into l and rounded to bf16 for the PV
//     product; O rounded to bf16 at the end;
//   - backward: P and dS rounded to bf16 before their products (dV = P^T
//     dO; dQ = dS K, dK = dS^T Q); dQ, dK and dV each rounded to bf16 once,
//     from their fp32 sums.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.  The tensor maps are
// encoded on the host by libcuda's cuTensorMapEncodeTiled, looked up in the
// already loaded libcuda.so.1 (hopper.cuh; no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;           // head_dim: the one the training path runs
constexpr int kThreads = 384;    // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
// stages of each kernel's TMA ring
constexpr int kFwdStages = 2;
constexpr int kDkdvStages = 2;
constexpr int kDqStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

// 2^(m - m_new), exact, for integer shifts m <= m_new; 0 for m = -inf
__device__ __forceinline__ float pow2_shift(float m, float m_new) {
  return m == -INFINITY ? 0.f : ldexpf(1.f, (int)(m - m_new));
}

// row max / sum over the 4 threads of a quad (they hold one row's columns)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a [R x 128] tile (two 64-column halves) by TMA, completing on `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row, int rows) {
  tma_load_2d(dst, map, bar, 0, row);
  tma_load_2d(dst + tile_bytes(rows) / 2, map, bar, 64, row);
}

// A 64 x 128 accumulator -> bf16 pairs in global memory (row stride D) at
// `out`, the thread's first row: its two rows, columns 8j + 2t, divided by
// div_a and div_b (true division, as the plain version's O / l; a divisor
// of 1 leaves the sums exact)
__device__ __forceinline__ void store_rows(uint16_t* out, const float (&acc)[64], int t,
                                           float div_a, float div_b) {
  uint16_t* pa = out + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(pa + 8 * j) =
        pack_bf16(acc[4 * j] / div_a, acc[4 * j + 1] / div_a);
    *reinterpret_cast<uint32_t*>(pa + 8 * D + 8 * j) =
        pack_bf16(acc[4 * j + 2] / div_b, acc[4 * j + 3] / div_b);
  }
}

// ---------------------------------------------------------------- forward
// shared: Q [128 x 128], K and V [128 x 128] per stage, barriers
constexpr int kFwdSmem = (1 + 2 * kFwdStages) * tile_bytes(128) + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int S, int n_rep, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int T = tile_bytes(128), ST = kFwdStages;
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t q_s = base;
  const uint32_t bar = base + (1 + 2 * ST) * T;  // q_full, k_full[ST], v_full[ST], empty[ST]
  auto k_s = [&](int s) { return base + T * (1 + s); };
  auto v_s = [&](int s) { return base + T * (1 + ST + s); };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * ST + s); };

  // the tile index is the slow grid dimension: every head's longest causal
  // tiles launch first, the shortest last
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int nk = causal ? qt + 1 : S / 128;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kv_row = (bh / n_rep) * S;
      mbar_expect_tx(bar, T);
      load_tile(q_s, &tm_q, bar, bh * S + qt * 128, 128);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), T);
        load_tile(k_s(s), &tm_k, k_full(s), kv_row + kt * 128, 128);
        mbar_expect_tx(v_full(s), T);
        load_tile(v_s(s), &tm_v, v_full(s), kv_row + kt * 128, 128);
      }
    }
  } else {  // consumers: 64 query rows each
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_a = qt * 128 + 64 * c + 16 * warp + g;  // this thread's two rows
    const int row_b = row_a + 8;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    mbar_wait(bar, 0);

    // tile kt <= qt holds key kt*128 <= every row of the q tile, so no row
    // of a visited tile is fully masked
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      const uint32_t par = (kt / ST) & 1;
      float sc[64];
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_ss_n128(sc, kmajor_desc<128>(q_s, 64 * c, kk), kmajor_desc<128>(k_s(s), 0, kk),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scores in log2 units, the causal mask (diagonal tile only), row max
      const bool diag = causal && kt == qt;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (diag && kt * 128 + 8 * j + 2 * t + (e & 1) > (e < 2 ? row_a : row_b)) x = -INFINITY;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], ceilf(quad_max(mx[i])));
        const float corr = pow2_shift(m[i], m_new);  // 0 on the first tile
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[4 * j + 2 * i] *= corr;
          acc[4 * j + 2 * i + 1] *= corr;
        }
      }
      // exponentials: fp32 into the row sums, bf16 into the PV product
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2f(sc[4 * j] - m[0]), p1 = exp2f(sc[4 * j + 1] - m[0]);
        const float p2 = exp2f(sc[4 * j + 2] - m[1]), p3 = exp2f(sc[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      mbar_wait(v_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n128_tb(acc, pa[kk], mnmajor_desc<128>(v_s(s), kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    store_rows(o + ((int64_t)bh * S + row_a) * D, acc, t, l[0], l[1]);
    if (t == 0) {
      lse[(int64_t)bh * S + row_a] = (m[0] + log2f(l[0])) * kLn2;
      lse[(int64_t)bh * S + row_b] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
}

// ---------------------------------------------------------- backward: delta
// delta[r] = sum_d dO[r, d] * O[r, d] in fp32; 16 threads per row, 16 bytes
// of each input per thread
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                       float* __restrict__ delta) {
  const int64_t row = (int64_t)blockIdx.x * 16 + threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
  const uint4 b = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(bv[i] << 16), __uint_as_float(av[i] << 16), s);
    s = fmaf(__uint_as_float(bv[i] & 0xffff0000u), __uint_as_float(av[i] & 0xffff0000u), s);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0) delta[row] = s;
}

// ---------------------------------------------------------- backward: dK, dV
// One block per (kv head, 128-key tile); consumer c owns keys 64c.. of the
// tile and works in the transposed frame: S^T = K Q^T, dP^T = V dO^T.
// shared: K, V [128 x 128]; per stage Q, dO [64 x 128], 64 LSE and 64 delta
constexpr int kDkdvSmem =
    2 * tile_bytes(128) + kDkdvStages * (2 * tile_bytes(64) + 512) + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, uint16_t* __restrict__ dk,
                      uint16_t* __restrict__ dv, int S, int n_rep, int causal, float scale,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int KT = tile_bytes(128), QT = tile_bytes(64), ST = kDkdvStages;
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t k_s = base, v_s = base + KT;
  auto q_s = [&](int s) { return base + 2 * KT + QT * s; };
  auto do_s = [&](int s) { return base + 2 * KT + QT * (ST + s); };
  const uint32_t vec = base + 2 * KT + 2 * ST * QT;  // lse[s][64], then delta[s][64]
  auto l_s = [&](int s) { return vec + 256 * s; };
  auto d_s = [&](int s) { return vec + 256 * (ST + s); };
  const uint32_t bar = vec + 512 * ST;  // kv_full, full[ST], empty[ST]
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + ST + s); };
  const float* vec_p = reinterpret_cast<const float*>(smem_raw + (vec - smem_addr(smem_raw)));

  const int kt = blockIdx.y;  // tile 0 has the most causal work: first, for every head
  const int bkv = blockIdx.x;
  const int q_first = causal ? 2 * kt : 0;  // 64-row q tiles before see no key here
  const int nq = S / 64;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, 2 * KT);
      load_tile(k_s, &tm_k, bar, bkv * S + kt * 128, 128);
      load_tile(v_s, &tm_v, bar, bkv * S + kt * 128, 128);
      int it = 0;
      for (int h = 0; h < n_rep; ++h) {
        const int bh = bkv * n_rep + h;
        for (int qi = q_first; qi < nq; ++qi, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          const int row = bh * S + qi * 64;
          mbar_expect_tx(full(s), 2 * QT + 512);
          load_tile(q_s(s), &tm_q, full(s), row, 64);
          load_tile(do_s(s), &tm_do, full(s), row, 64);
          bulk_load(l_s(s), lse + row, 256, full(s));
          bulk_load(d_s(s), delta + row, 256, full(s));
        }
      }
    }
  } else {  // consumers: 64 keys each
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = kt * 128 + 64 * c;
    const int key_a = key0 + 16 * warp + g;  // this thread's two keys
    const int key_b = key_a + 8;
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(bar, 0);

    int it = 0;
    for (int h = 0; h < n_rep; ++h) {
      for (int qi = q_first; qi < nq; ++qi, ++it) {
        const int s = it % ST;
        mbar_wait(full(s), (it / ST) & 1);
        if (!causal || qi * 64 >= key0) {  // else every row precedes every key
          // two wgmma groups: S^T, then dP^T; P^T is formed while dP^T runs
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            wgmma_ss_n64(st, kmajor_desc<128>(k_s, 64 * c, kk), kmajor_desc<64>(q_s(s), 0, kk),
                         kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            wgmma_ss_n64(dpt, kmajor_desc<128>(v_s, 64 * c, kk), kmajor_desc<64>(do_s(s), 0, kk),
                         kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(st);

          // P^T from the saved LSE (fp32, in place) while dP^T runs
          const bool diag = causal && qi * 64 == key0;
          const float* ls = vec_p + 64 * s;
          const float* dl = vec_p + 64 * (ST + s);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t + (e & 1);
              float x = st[4 * j + e] * scale_log2 - ls[qc] * kLog2e;
              if (diag && (e < 2 ? key_a : key_b) > qi * 64 + qc) x = -INFINITY;  // exp2: 0
              st[4 * j + e] = exp2f(x);
            }
          }
          wgmma_wait<0>();
          fence_regs(dpt);
          // per half of the 64 q rows: P^T and dS^T = P^T (dP^T - delta) *
          // scale as bf16 fragments, then dV += P^T dO and dK += dS^T Q
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
              wgmma_rs_n128_tb(dva, pa[kk], mnmajor_desc<64>(do_s(s), 2 * hh + kk), 1);
              wgmma_rs_n128_tb(dka, dsa[kk], mnmajor_desc<64>(q_s(s), 2 * hh + kk), 1);
            }
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
    const int64_t at = ((int64_t)bkv * S + key_a) * D;
    store_rows(dk + at, dka, t, 1.f, 1.f);
    store_rows(dv + at, dva, t, 1.f, 1.f);
  }
}

// -------------------------------------------------------------- backward: dQ
// One block per (q head, 128-row q tile); consumer c owns rows 64c...
// shared: Q, dO [128 x 128]; per stage K, V [64 x 128]
constexpr int kDqSmem = 2 * tile_bytes(128) + 2 * kDqStages * tile_bytes(64) + 128 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, uint16_t* __restrict__ dq, int S, int n_rep,
                    int causal, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int QT = tile_bytes(128), KT = tile_bytes(64), ST = kDqStages;
  const uint32_t base = align1024(smem_addr(smem_raw));
  const uint32_t q_s = base, do_s = base + QT;
  auto k_s = [&](int s) { return base + 2 * QT + KT * s; };
  auto v_s = [&](int s) { return base + 2 * QT + KT * (ST + s); };
  const uint32_t bar = base + 2 * QT + 2 * ST * KT;  // q_full, full[ST], empty[ST]
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + ST + s); };

  // the tile index is the slow grid dimension: every head's longest causal
  // tiles launch first, the shortest last
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int nk = causal ? 2 * qt + 2 : S / 64;  // 64-key tiles
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kv_row = (bh / n_rep) * S;
      mbar_expect_tx(bar, 2 * QT);
      load_tile(q_s, &tm_q, bar, bh * S + qt * 128, 128);
      load_tile(do_s, &tm_do, bar, bh * S + qt * 128, 128);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KT);
        load_tile(k_s(s), &tm_k, full(s), kv_row + kt * 64, 64);
        load_tile(v_s(s), &tm_v, full(s), kv_row + kt * 64, 64);
      }
    }
  } else {  // consumers: 64 query rows each
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = qt * 128 + 64 * c;
    const int row_a = row0 + 16 * warp + g;  // this thread's two rows
    const int row_b = row_a + 8;
    const int64_t at = (int64_t)bh * S;
    const float lse_a = lse[at + row_a] * kLog2e, lse_b = lse[at + row_b] * kLog2e;
    const float d_a = delta[at + row_a], d_b = delta[at + row_b];
    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
    mbar_wait(bar, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(full(s), (kt / ST) & 1);
      if (!causal || kt * 64 <= row0 + 63) {  // else every key follows every row
        // two wgmma groups: S, then dP; P is formed while dP runs
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_ss_n64(sc, kmajor_desc<128>(q_s, 64 * c, kk), kmajor_desc<64>(k_s(s), 0, kk),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_ss_n64(dp, kmajor_desc<128>(do_s, 64 * c, kk), kmajor_desc<64>(v_s(s), 0, kk),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        const bool diag = causal && kt * 64 + 63 > row0;
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
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128_tb(dqa, dsa[kk], mnmajor_desc<64>(k_s(s), kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }
    store_rows(dq + (at + row_a) * D, dqa, t, 1.f, 1.f);
  }
}

// ------------------------------------------------------------------- host
// tensor map over a contiguous [rows x 128] bf16 array: boxes of
// box_rows x 64 columns, 128-byte swizzle (what the kernels' descriptors read)
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int64_t rows, int box_rows) {
  const cuuint64_t dims[2] = {D, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {D * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return bf16_tensor_map(map, ptr, 2, dims, strides, box);
}

// above 48 KB a kernel's dynamic shared memory needs an opt-in, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

// head_dim 128 only (the one the training path runs); S a multiple of the
// 128-row tiles
bool bad_shape(int bhq, int bhkv, int S, int D_) {
  return bhq <= 0 || bhkv <= 0 || bhq % bhkv != 0 || S <= 0 || S % 128 != 0 || D_ != D;
}

#define RETURN_IF_ERROR(x)                  \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

}  // namespace

// q [bhq, S, D], k/v [bhkv, S, D] bf16; o [bhq, S, D] bf16 and lse [bhq, S]
// fp32 out.  scale_log2 = softmax scale * log2(e).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bhq, int bhkv, int S, int D_, int causal,
                                        float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S, D_)) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  RETURN_IF_ERROR(allow_smem(flash_fwd_kernel, kFwdSmem, ready));
  CUtensorMap mq, mk, mv;
  RETURN_IF_ERROR(tile_map(&mq, q, (int64_t)bhq * S, 128));
  RETURN_IF_ERROR(tile_map(&mk, k, (int64_t)bhkv * S, 128));
  RETURN_IF_ERROR(tile_map(&mv, v, (int64_t)bhkv * S, 128));
  flash_fwd_kernel<<<dim3(bhq, S / 128), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
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
  if (bad_shape(bhq, bhkv, S, D_)) return (int)cudaErrorInvalidValue;
  static bool dkdv_ready = false, dq_ready = false;
  RETURN_IF_ERROR(allow_smem(flash_bwd_dkdv_kernel, kDkdvSmem, dkdv_ready));
  RETURN_IF_ERROR(allow_smem(flash_bwd_dq_kernel, kDqSmem, dq_ready));
  const int64_t rows_q = (int64_t)bhq * S, rows_kv = (int64_t)bhkv * S;
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  RETURN_IF_ERROR(tile_map(&q64, q, rows_q, 64));
  RETURN_IF_ERROR(tile_map(&do64, dout, rows_q, 64));
  RETURN_IF_ERROR(tile_map(&k128, k, rows_kv, 128));
  RETURN_IF_ERROR(tile_map(&v128, v, rows_kv, 128));
  RETURN_IF_ERROR(tile_map(&q128, q, rows_q, 128));
  RETURN_IF_ERROR(tile_map(&do128, dout, rows_q, 128));
  RETURN_IF_ERROR(tile_map(&k64, k, rows_kv, 64));
  RETURN_IF_ERROR(tile_map(&v64, v, rows_kv, 64));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  const int n_rep = bhq / bhkv;
  flash_bwd_delta_kernel<<<(unsigned)(rows_q / 16), 256, 0, st>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout), d);
  RETURN_IF_ERROR(cudaGetLastError());
  flash_bwd_dkdv_kernel<<<dim3(bhkv, S / 128), kThreads, kDkdvSmem, st>>>(
      q64, k128, v128, do64, l, d, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), S,
      n_rep, causal, scale, scale_log2);
  RETURN_IF_ERROR(cudaGetLastError());
  flash_bwd_dq_kernel<<<dim3(bhq, S / 128), kThreads, kDqSmem, st>>>(
      q128, k64, v64, do128, l, d, static_cast<uint16_t*>(dq), S, n_rep, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
