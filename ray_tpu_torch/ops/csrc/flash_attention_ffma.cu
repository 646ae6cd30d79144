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
// inputs and outputs 0.24 ms at 3.35 TB/s.  The design is the simple one that
// is right first:
//   - every product by FFMA from shared memory, one fp32 sum per output;
//     tiles of 64 queries and 32 keys, staged in shared memory as fp32 rows
//     padded to D + 1 floats so a warp's 16 key (or query) rows fall in 16
//     banks; 256 threads, a thread owning a 4 x 2 score tile and 4 rows x
//     D/16 columns of the output (columns t, t + 16, ...);
//   - shared memory at D = 256: forward 64 + 2 x 32 rows of 257 floats and a
//     64 x 33 P tile, 140 KB; dK/dV 2 x 32 + 2 x 64 rows, two 32 x 65 tiles
//     and 128 row values, 215 KB; dQ 2 x 64 + 2 x 32 rows and a 64 x 33 dS
//     tile, 206 KB (all under the 227 KB a block may take: one block per SM);
//   - registers: the forward's O accumulator is 4 x D/16 floats (64 at
//     D = 256), dK/dV's two accumulators 2 x D/16 each, dQ's 4 x D/16.
// Making them fast (wider tiles, a pipeline) is later work; their times are
// in PERF.md.
//
// The algorithm is flash_attention.cu's, with every rounding point a no-op
// at fp32:
//   - forward: one block per (q head, 64-row q tile), the longest causal
//     tiles first; 32-key tiles up to the causal diagonal; online softmax in
//     log2 units with the running max rounded UP to an integer (every
//     rescale an exact power of two); exponentials summed into l and into
//     the PV product;
//   - backward, three launches, no atomics: delta = rowsum(dO * O); dK/dV,
//     one block per (kv head, 32-key tile) over the group's q heads and
//     64-row q tiles from the diagonal on; dQ, one block per (q head, 64-row
//     q tile) over 32-key tiles up to the diagonal.  Each gradient is one
//     fp32 sum.
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
constexpr int BQ = 64;  // query rows of a tile
constexpr int BK = 32;  // keys of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// rows [row0, row0 + rows) of a [*, D] array into shared rows of D + 1 floats
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t row0, int rows) {
  const float* g = src + row0 * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) dst[(i / D) * (D + 1) + i % D] = g[i];
}

// sum over the 16 lanes of a half warp (the threads of one score row)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D>
constexpr int fwd_smem() { return ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4; }
template <int D>
constexpr int dkdv_smem() { return ((2 * BK + 2 * BQ) * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ) * 4; }
template <int D>
constexpr int dq_smem() { return ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4; }

// ---------------------------------------------------------------- forward
// thread t: tx = t % 16, ty = t / 16; score rows 4 ty + i (i < 4), keys
// tx + 16 j (j < 2); output rows 4 ty + i, columns tx + 16 c (c < D / 16)
template <int D>
__global__ void __launch_bounds__(kThreads) ffma_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int n_rep, int causal,
    float scale_log2) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;  // [BQ][BK + 1]
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int64_t kv_row0 = (int64_t)(bh / n_rep) * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<D>(qs, q, (int64_t)bh * S + qt * BQ, BQ);
  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = causal ? (qt + 1) * (BQ / BK) : S / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the last tile's products are done with ks, vs, ps
    load_rows<D>(ks, k, kv_row0 + kt * BK, BK);
    load_rows<D>(vs, v, kv_row0 + kt * BK, BK);
    __syncthreads();
    float s[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qt * BQ + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] *= scale_log2;
        if (causal && kt * BK + tx + 16 * j > qi) s[i][j] = -INFINITY;  // exp2: 0
      }
      // a row fully masked in this tile keeps its max: its first tile had key 0
      const float m_new = fmaxf(m[i], ceilf(half_warp_max(fmaxf(s[i][0], s[i][1]))));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      const float p0 = exp2f(s[i][0] - m_new), p1 = exp2f(s[i][1] - m_new);
      l[i] = l[i] * alpha + p0 + p1;  // this lane's keys; summed over lanes at the end
      ps[(4 * ty + i) * (BK + 1) + tx] = p0;
      ps[(4 * ty + i) * (BK + 1) + tx + 16] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = half_warp_sum(l[i]);
    const int64_t row = (int64_t)bh * S + qt * BQ + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[row * D + tx + 16 * c] = acc[i][c] / li;
    if (tx == 0) lse[row] = (m[i] + log2f(li)) * kLn2;
  }
}

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

// dK, dV: one block per (kv head, 32-key tile).  Thread: S^T rows (keys)
// 2 ty + i (i < 2), columns (queries) tx + 16 j (j < 4); dK/dV rows 2 ty + i,
// columns tx + 16 c
template <int D>
__global__ void __launch_bounds__(kThreads) ffma_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int n_rep, int causal, float scale,
    float scale_log2) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* pts = dos + BQ * LD;       // P^T [BK][BQ + 1]
  float* dsts = pts + BK * (BQ + 1);  // dS^T [BK][BQ + 1]
  float* ls = dsts + BK * (BQ + 1);   // LSE in log2 units [BQ]
  float* dl = ls + BQ;                // delta [BQ]
  const int kvh = blockIdx.x, kt = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<D>(ks, k, (int64_t)kvh * S + kt * BK, BK);
  load_rows<D>(vs, v, (int64_t)kvh * S + kt * BK, BK);
  float dka[2][NC], dva[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  const int qt0 = causal ? (kt * BK) / BQ : 0;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int bh = kvh * n_rep + rep;
    for (int qt = qt0; qt < S / BQ; ++qt) {
      __syncthreads();  // the last tile's products are done with qs, dos, pts, dsts
      const int64_t row0 = (int64_t)bh * S + qt * BQ;
      load_rows<D>(qs, q, row0, BQ);
      load_rows<D>(dos, dout, row0, BQ);
      if (threadIdx.x < BQ) {
        ls[threadIdx.x] = lse[row0 + threadIdx.x] * kLog2e;
        dl[threadIdx.x] = delta[row0 + threadIdx.x];
      }
      __syncthreads();
      float st[2][4] = {}, dpt[2][4] = {};
      for (int d = 0; d < D; ++d) {
        float a[2], b[2], x[4], y[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i] = ks[(2 * ty + i) * LD + d];
          b[i] = vs[(2 * ty + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = qs[(tx + 16 * j) * LD + d];
          y[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(a[i], x[j], st[i][j]);
            dpt[i][j] = fmaf(b[i], y[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kt * BK + 2 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          float x = st[i][j] * scale_log2 - ls[qc];
          if (causal && key > qt * BQ + qc) x = -INFINITY;  // exp2: 0
          const float p = exp2f(x);
          pts[(2 * ty + i) * (BQ + 1) + qc] = p;
          dsts[(2 * ty + i) * (BQ + 1) + qc] = p * (dpt[i][j] - dl[qc]) * scale;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < BQ; ++kk) {
        float p[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          p[i] = pts[(2 * ty + i) * (BQ + 1) + kk];
          ds[i] = dsts[(2 * ty + i) * (BQ + 1) + kk];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float gd = dos[kk * LD + tx + 16 * c], qq = qs[kk * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dva[i][c] = fmaf(p[i], gd, dva[i][c]);
            dka[i][c] = fmaf(ds[i], qq, dka[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = (int64_t)kvh * S + kt * BK + 2 * ty + i;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row * D + tx + 16 * c] = dka[i][c];
      dv[row * D + tx + 16 * c] = dva[i][c];
    }
  }
}

// dQ: one block per (q head, 64-row q tile).  Thread: score rows 4 ty + i,
// keys tx + 16 j (j < 2); dQ rows 4 ty + i, columns tx + 16 c
template <int D>
__global__ void __launch_bounds__(kThreads) ffma_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, int n_rep, int causal, float scale, float scale_log2) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;  // dS [BQ][BK + 1]
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int64_t row0 = (int64_t)bh * S + qt * BQ, kv_row0 = (int64_t)(bh / n_rep) * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<D>(qs, q, row0, BQ);
  load_rows<D>(dos, dout, row0, BQ);
  float l2[4], dl[4], dqa[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l2[i] = lse[row0 + 4 * ty + i] * kLog2e;
    dl[i] = delta[row0 + 4 * ty + i];
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[i][c] = 0.f;
  }
  const int n_kt = causal ? (qt + 1) * (BQ / BK) : S / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows<D>(ks, k, kv_row0 + kt * BK, BK);
    load_rows<D>(vs, v, kv_row0 + kt * BK, BK);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[2], w[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(4 * ty + i) * LD + d];
        g[i] = dos[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j] = ks[(tx + 16 * j) * LD + d];
        w[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qt * BQ + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j] * scale_log2 - l2[i];
        if (causal && kt * BK + tx + 16 * j > qi) x = -INFINITY;
        const float p = exp2f(x);
        dss[(4 * ty + i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(4 * ty + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][c] = fmaf(ds[i], kv, dqa[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[row * D + tx + 16 * c] = dqa[i][c];
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
  constexpr int smem = fwd_smem<D>();
  RETURN_IF_ERROR(allow_smem(ffma_fwd_kernel<D>, smem));
  ffma_fwd_kernel<D><<<dim3(bhq, S / BQ), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, bhq / bhkv, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int bhq, int bhkv, int S,
        int causal, float scale, float scale_log2, cudaStream_t st) {
  constexpr int smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  RETURN_IF_ERROR(allow_smem(ffma_dkdv_kernel<D>, smem_kv));
  RETURN_IF_ERROR(allow_smem(ffma_dq_kernel<D>, smem_q));
  const int64_t rows = (int64_t)bhq * S;
  const int n_rep = bhq / bhkv;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* gg = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  ffma_delta_kernel<D><<<(unsigned)((rows + 7) / 8), kThreads, 0, st>>>(
      static_cast<const float*>(o), gg, d, rows);
  RETURN_IF_ERROR(cudaGetLastError());
  ffma_dkdv_kernel<D><<<dim3(bhkv, S / BK), kThreads, smem_kv, st>>>(
      qq, kk, vv, gg, l, d, static_cast<float*>(dk), static_cast<float*>(dv), S, n_rep, causal,
      scale, scale_log2);
  RETURN_IF_ERROR(cudaGetLastError());
  ffma_dq_kernel<D><<<dim3(bhq, S / BQ), kThreads, smem_q, st>>>(
      qq, kk, vv, gg, l, d, static_cast<float*>(dq), S, n_rep, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

bool bad_shape(int bhq, int bhkv, int S) {
  return bhq <= 0 || bhkv <= 0 || bhq % bhkv != 0 || S <= 0 || S % BQ != 0;
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

// Adds o and dout [bhq, S, D] and the forward's lse [bhq, S]; delta [bhq, S]
// is scratch; dq [bhq, S, D], dk/dv [bhkv, S, D] out; all fp32.
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
