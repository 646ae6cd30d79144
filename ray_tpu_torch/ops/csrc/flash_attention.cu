// Flash attention forward and backward for Hopper (sm_90a), bf16 inputs.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/flash_attention.py:_fwd_kernel
// (forward: O and the log-sum-exp) and :_bwd_kernel (dQ, dK, dV from the
// saved LSE).  Layout as the TPU wrappers: q [B*Hq, S, D], k/v [B*Hkv, S, D],
// contiguous; the kv head of q head bh is bh / n_rep.
//
// What bounds it on the H100: operations.  At the training shapes (B=8,
// S=2048, Hq=16, D=128, causal) the forward does 4*B*Hq*D*S(S+1)/2 =
// 1.375e11 flops on 0.2 GB of inputs and outputs, the backward five
// products (2.5x that) on 0.54 GB: both sit far above the ~295 flops/byte
// where bf16 tensor cores, not HBM, become the limit.  So the products run
// on the tensor cores: mma.sync m16n8k16, bf16 operands, fp32 accumulation.
// Fragments are read from shared memory with plain 32-bit loads (two 16-bit
// loads where the operand is transposed); no ldmatrix, cp.async, TMA or
// wgmma yet -- those are the performance work left for later.
//
// Not the TPU design.  The TPU kernel keeps a whole sequence's K and V in
// VMEM, and its backward accumulates dK/dV in output blocks that the
// sequential Pallas grid revisits across q-blocks and across the n_rep q
// heads of a kv head.  Hopper blocks run in parallel and in no order, so:
//   - forward: one block of 4 warps per (q head, 64-row q tile), each warp
//     16 rows; K/V tiles of 64 keys stream through shared memory up to the
//     causal diagonal; fp32 online softmax in registers;
//   - backward, three launches, no atomics (deterministic):
//       delta  one warp per row: rowsum(dO * O) in fp32;
//       dK/dV  one block per (kv head, 64-key tile): loops over the n_rep
//              q heads of its group and over 32-row q tiles from the
//              diagonal to the end, accumulating dK and dV in registers;
//       dQ     one block per (q head, 64-row q tile): loops over 32-key
//              tiles up to the diagonal, accumulating dQ in registers.
//
// Rounding points (plain version: flash_attention_{fwd,bwd}_reference in
// ray_tpu_torch/ops/flash_attention.py rounds the same values):
//   - forward: exponentials rounded to bf16 before the PV product (the TPU
//     kernel's p.astype(v.dtype)); the row sum takes them unrounded; O is
//     rounded to bf16 at the end.  The softmax shift is the running max in
//     log2 units rounded UP to an integer, so every rescale is an exact
//     power of two that moves no bf16 rounding: the plain version shifts by
//     the row's max rounded up once and rounds the same values;
//   - backward: dS rounded to bf16 before dQ = dS K and dK = dS^T Q (as
//     the TPU kernel does); and, for the tensor cores, P rounded to bf16
//     before dV = P^T dO (the TPU kernel takes P in fp32 there).  dO is bf16
//     already.  dQ, dK, dV are written in fp32; the caller casts.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> bf16x2 (round to nearest even); `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_to_float(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// 2^(m - m_new), exact, for integer shifts m <= m_new; 0 for m = -inf
__device__ __forceinline__ float pow2_shift(float m, float m_new) {
  return m == -INFINITY ? 0.f : ldexpf(1.f, (int)(m - m_new));
}

// Fragment loads from a shared tile with row stride LD (elements); g is
// lane / 4, t is lane % 4 (the mma.sync m16n8k16 thread layout).
//
// A (16 x 16, row major): rows row0.., columns k0..
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* s, int row0,
                                       int k0, int g, int t) {
  const uint16_t* p = s + (row0 + g) * LD + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B (16 x 8) whose element (k, n) sits at s[n * LD + k]: k contiguous
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint16_t* s, int n0,
                                       int k0, int g, int t) {
  const uint16_t* p = s + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B (16 x 8) whose element (k, n) sits at s[k * LD + n]: n contiguous
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[2], const uint16_t* s, int k0,
                                             int n0, int g, int t) {
  const uint16_t* p = s + (k0 + 2 * t) * LD + n0 + g;
  b[0] = p[0] | (static_cast<uint32_t>(p[LD]) << 16);
  b[1] = p[8 * LD] | (static_cast<uint32_t>(p[9 * LD]) << 16);
}

// rows x D bf16 tile from global (row stride D) into shared (row stride
// LD), 16 bytes per thread per step
template <int D, int LD>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* src, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(s + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (int64_t)r * D + c);
  }
}

// row max over the 4 threads of a quad (they hold one row's columns)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int S, int n_rep, int causal, float scale_log2) {
  constexpr int BM = 64, BN = 64, LD = D + 8, KD = D / 16, ND = D / 8, NT = BN / 8;
  __shared__ __align__(16) uint16_t Ks[BN * LD];
  __shared__ __align__(16) uint16_t Vs[BN * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int row_a = qt * BM + r0 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const uint16_t* kb = k + (int64_t)(bh / n_rep) * S * D;
  const uint16_t* vb = v + (int64_t)(bh / n_rep) * S * D;

  // the warp's 16 query rows as A fragments, straight from global memory
  uint32_t qa[KD][4];
  {
    const uint16_t* p = q + ((int64_t)bh * S + row_a) * D + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qa[kk][0] = ld32(p + kk * 16);
      qa[kk][1] = ld32(p + 8 * D + kk * 16);
      qa[kk][2] = ld32(p + kk * 16 + 8);
      qa[kk][3] = ld32(p + 8 * D + kk * 16 + 8);
    }
  }
  float acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // BM == BN: tile kt <= qt always holds key kt*BN <= every row of the
  // q tile, so no row of a visited tile is fully masked
  const int nk = causal ? qt + 1 : S / BN;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, LD>(Ks, kb + (int64_t)kt * BN * D, BN);
    load_tile<D, LD>(Vs, vb + (int64_t)kt * BN * D, BN);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        load_b<LD>(b, Ks, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], qa[kk], b);
      }
    }
    // scores in log2 units, causal mask, the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale_log2;
        if (causal && col > (e < 2 ? row_a : row_b)) x = -INFINITY;
        s[nt][e] = x;
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
      for (int dt = 0; dt < ND; ++dt) {
        acc[dt][2 * i] *= corr;
        acc[dt][2 * i + 1] *= corr;
      }
    }
    // exponentials: fp32 into the row sums, bf16 into the PV product
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
      const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        uint32_t b[2];
        load_b_trans<LD>(b, Vs, kk * 16, dt * 8, g, t);
        mma_bf16(acc[dt], pa[kk], b);
      }
    }
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  uint16_t* oa = o + ((int64_t)bh * S + row_a) * D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    *reinterpret_cast<uint32_t*>(oa + dt * 8) = pack_bf16(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    *reinterpret_cast<uint32_t*>(oa + 8 * D + dt * 8) =
        pack_bf16(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
  if (t == 0) {
    lse[(int64_t)bh * S + row_a] = (m[0] + log2f(l[0])) * kLn2;
    lse[(int64_t)bh * S + row_b] = (m[1] + log2f(l[1])) * kLn2;
  }
}

// ---------------------------------------------------------- backward: delta
// delta[r] = sum_d dO[r, d] * O[r, d] in fp32; one warp per row
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    s = fmaf(bf16_to_float(dout[row * D + d]), bf16_to_float(o[row * D + d]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------- backward: dK, dV
// One block per (kv head, 64-key tile); warp w owns keys [16w, 16w + 16) of
// the tile and works in the transposed frame: S^T = K Q^T, dP^T = V dO^T.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int n_rep,
                      int causal, float scale, float scale_log2) {
  constexpr int BN = 64, BQ = 32, LD = D + 8, KD = D / 16, ND = D / 8, NT = BQ / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = Ks + BN * LD;
  uint16_t* Qs = Vs + BN * LD;
  uint16_t* dOs = Qs + BQ * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BQ * LD);  // lse in log2 units
  float* Ds = Ls + BQ;

  const int kt = blockIdx.x;  // tile 0 has the most causal work: first
  const int bkv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int key_a = kt * BN + r0 + g;
  const int key_b = key_a + 8;
  load_tile<D, LD>(Ks, k + ((int64_t)bkv * S + kt * BN) * D, BN);
  load_tile<D, LD>(Vs, v + ((int64_t)bkv * S + kt * BN) * D, BN);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }
  const int q_first = causal ? kt * BN / BQ : 0;  // rows before see no key here
  for (int h = 0; h < n_rep; ++h) {
    const int64_t bh = (int64_t)bkv * n_rep + h;
    for (int qi = q_first; qi < S / BQ; ++qi) {
      __syncthreads();
      load_tile<D, LD>(Qs, q + (bh * S + qi * BQ) * D, BQ);
      load_tile<D, LD>(dOs, dout + (bh * S + qi * BQ) * D, BQ);
      if (threadIdx.x < BQ) {
        Ls[threadIdx.x] = lse[bh * S + qi * BQ + threadIdx.x] * kLog2e;
        Ds[threadIdx.x] = delta[bh * S + qi * BQ + threadIdx.x];
      }
      __syncthreads();

      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        load_a<LD>(ak, Ks, r0, kk * 16, g, t);
        load_a<LD>(av, Vs, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[2];
          load_b<LD>(b, Qs, nt * 8, kk * 16, g, t);
          mma_bf16(st[nt], ak, b);
          load_b<LD>(b, dOs, nt * 8, kk * 16, g, t);
          mma_bf16(dpt[nt], av, b);
        }
      }
      // P^T from the saved LSE; dS^T = P^T (dP^T - delta) * scale
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * t + (e & 1);
          const bool masked = causal && (e < 2 ? key_a : key_b) > qi * BQ + qc;
          p[e] = masked ? 0.f : exp2f(st[nt][e] * scale_log2 - Ls[qc]);
          ds[e] = p[e] * (dpt[nt][e] - Ds[qc]) * scale;
        }
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[nt / 2][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P^T dO ; dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          uint32_t b[2];
          load_b_trans<LD>(b, dOs, kk * 16, dt * 8, g, t);
          mma_bf16(dva[dt], pa[kk], b);
          load_b_trans<LD>(b, Qs, kk * 16, dt * 8, g, t);
          mma_bf16(dka[dt], dsa[kk], b);
        }
      }
    }
  }
  float* dka_p = dk + ((int64_t)bkv * S + key_a) * D + 2 * t;
  float* dva_p = dv + ((int64_t)bkv * S + key_a) * D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    *reinterpret_cast<float2*>(dka_p + dt * 8) = make_float2(dka[dt][0], dka[dt][1]);
    *reinterpret_cast<float2*>(dka_p + 8 * D + dt * 8) = make_float2(dka[dt][2], dka[dt][3]);
    *reinterpret_cast<float2*>(dva_p + dt * 8) = make_float2(dva[dt][0], dva[dt][1]);
    *reinterpret_cast<float2*>(dva_p + 8 * D + dt * 8) = make_float2(dva[dt][2], dva[dt][3]);
  }
}

// -------------------------------------------------------------- backward: dQ
// One block per (q head, 64-row q tile); warp w owns rows [16w, 16w + 16).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S, int n_rep, int causal, float scale,
                    float scale_log2) {
  constexpr int BM = 64, BN = 32, LD = D + 8, KD = D / 16, ND = D / 8, NT = BN / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dOs = Qs + BM * LD;
  uint16_t* Ks = dOs + BM * LD;
  uint16_t* Vs = Ks + BN * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int64_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int row_a = qt * BM + r0 + g;
  const int row_b = row_a + 8;
  const uint16_t* kb = k + (bh / n_rep) * S * D;
  const uint16_t* vb = v + (bh / n_rep) * S * D;
  load_tile<D, LD>(Qs, q + (bh * S + qt * BM) * D, BM);
  load_tile<D, LD>(dOs, dout + (bh * S + qt * BM) * D, BM);
  const float lse_a = lse[bh * S + row_a] * kLog2e, lse_b = lse[bh * S + row_b] * kLog2e;
  const float d_a = delta[bh * S + row_a], d_b = delta[bh * S + row_b];

  float dqa[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;
  const int nk = causal ? (qt + 1) * BM / BN : S / BN;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<D, LD>(Ks, kb + (int64_t)kt * BN * D, BN);
    load_tile<D, LD>(Vs, vb + (int64_t)kt * BN * D, BN);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, Qs, r0, kk * 16, g, t);
      load_a<LD>(ado, dOs, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        load_b<LD>(b, Ks, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], aq, b);
        load_b<LD>(b, Vs, nt * 8, kk * 16, g, t);
        mma_bf16(dp[nt], ado, b);
      }
    }
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const bool masked = causal && col > (lo ? row_a : row_b);
        const float p = masked ? 0.f : exp2f(s[nt][e] * scale_log2 - (lo ? lse_a : lse_b));
        ds[e] = p * (dp[nt][e] - (lo ? d_a : d_b)) * scale;
      }
      dsa[nt / 2][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        uint32_t b[2];
        load_b_trans<LD>(b, Ks, kk * 16, dt * 8, g, t);
        mma_bf16(dqa[dt], dsa[kk], b);
      }
    }
  }
  float* out = dq + (bh * S + row_a) * D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    *reinterpret_cast<float2*>(out + dt * 8) = make_float2(dqa[dt][0], dqa[dt][1]);
    *reinterpret_cast<float2*>(out + 8 * D + dt * 8) = make_float2(dqa[dt][2], dqa[dt][3]);
  }
}

// shared bytes of the two backward kernels: two 64-row and two 32-row
// bf16 tiles (+ the dK/dV kernel's 32 lse and delta values)
template <int D>
constexpr int bwd_smem_bytes() {
  return (2 * 64 + 2 * 32) * (D + 8) * 2 + 2 * 32 * 4;
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

template <int D>
cudaError_t launch_fwd(const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* o,
                       float* lse, int bhq, int S, int n_rep, int causal, float scale_log2,
                       cudaStream_t st) {
  flash_fwd_kernel<D><<<dim3(S / 64, bhq), kThreads, 0, st>>>(q, k, v, o, lse, S, n_rep,
                                                               causal, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                       const uint16_t* o, const uint16_t* dout, const float* lse, float* delta,
                       float* dq, float* dk, float* dv, int bhq, int bhkv, int S, int n_rep,
                       int causal, float scale, float scale_log2, cudaStream_t st) {
  static bool dkdv_ready = false, dq_ready = false;
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<D>, smem, dkdv_ready);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dq_kernel<D>, smem, dq_ready);
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)bhq * S;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, delta, rows, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<D><<<dim3(S / 64, bhkv), kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, n_rep, causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<D><<<dim3(S / 64, bhq), kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, S, n_rep, causal, scale, scale_log2);
  return cudaGetLastError();
}

// head_dim 128 only: the one the training path runs and the card tests
bool bad_shape(int bhq, int bhkv, int S, int D) {
  return bhq <= 0 || bhkv <= 0 || bhq % bhkv != 0 || S <= 0 || S % 64 != 0 || D != 128;
}

}  // namespace

// q [bhq, S, D], k/v [bhkv, S, D] bf16; o [bhq, S, D] bf16 and lse [bhq, S]
// fp32 out.  scale_log2 = softmax scale * log2(e).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bhq, int bhkv, int S, int D,
                                        int causal, float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S, D)) return (int)cudaErrorInvalidValue;
  const uint16_t* q16 = static_cast<const uint16_t*>(q);
  const uint16_t* k16 = static_cast<const uint16_t*>(k);
  const uint16_t* v16 = static_cast<const uint16_t*>(v);
  uint16_t* o16 = static_cast<uint16_t*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rep = bhq / bhkv;
  return (int)launch_fwd<128>(q16, k16, v16, o16, l, bhq, S, n_rep, causal, scale_log2, st);
}

// Adds o and dout [bhq, S, D] bf16 and the forward's lse [bhq, S]; delta
// [bhq, S] fp32 is scratch; dq [bhq, S, D], dk/dv [bhkv, S, D] fp32 out.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int bhq,
                                        int bhkv, int S, int D, int causal, float scale,
                                        float scale_log2, void* stream) {
  if (bad_shape(bhq, bhkv, S, D)) return (int)cudaErrorInvalidValue;
  const uint16_t* q16 = static_cast<const uint16_t*>(q);
  const uint16_t* k16 = static_cast<const uint16_t*>(k);
  const uint16_t* v16 = static_cast<const uint16_t*>(v);
  const uint16_t* o16 = static_cast<const uint16_t*>(o);
  const uint16_t* do16 = static_cast<const uint16_t*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* dq32 = static_cast<float*>(dq);
  float* dk32 = static_cast<float*>(dk);
  float* dv32 = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rep = bhq / bhkv;
  return (int)launch_bwd<128>(q16, k16, v16, o16, do16, l, d, dq32, dk32, dv32, bhq, bhkv, S,
                              n_rep, causal, scale, scale_log2, st);
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
