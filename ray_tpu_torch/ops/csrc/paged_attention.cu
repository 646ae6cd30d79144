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
// pair it reads, far below the ~295 flops/byte where the tensor cores
// would become the limit.  The design therefore aims only at reading the
// live span once, in 16-byte loads, with enough loads in flight:
//   - one thread block per (batch row, kv head); the block loads its G
//     query rows once into registers;
//   - it walks only the row's live pages (ceil((lengths+1)/bs) entries of
//     its table row); pages past the span are never read, so stale or NaN
//     pages cannot leak -- the contract the TPU kernel keeps by zeroing a
//     skipped chunk's contribution;
//   - HD/8 lanes share one token (8 bf16 = 16 bytes each), so a warp reads
//     32/(HD/8) tokens at once, and each thread keeps U tokens' K and V
//     loads in flight;
//   - each warp streams its share of the span with an online softmax in
//     fp32: per chunk of U * 32/(HD/8) tokens it takes the chunk's max,
//     rescales its running sum and accumulator, and adds exp(s - m) times
//     V.  As in the TPU kernel, the sum takes the fp32 exponentials and the
//     PV product takes them rounded to bf16 (the cache dtype).  Nothing
//     grows with the span: any table width runs;
//   - the shift m is the running max in log2 units rounded up to an
//     integer, so every rescale is an exact power of two and the values
//     rounded to bf16 are those of the plain version (attend_gathered in
//     paged_attention.py, which shifts by the row's max rounded up):
//     kernel and gather paths differ by fp32 summation order, not by
//     where they round;
//   - the warps merge their (m, l, acc) through shared memory in a fixed
//     order, so the result is deterministic.
//
// Left for later work: no wgmma, TMA or split-KV.  At B=8 and 8 kv heads
// the grid is 64 blocks on 132 SMs, and one block walks a whole row's
// span, so the longest row sets the time and the card's bandwidth is far
// from used; splitting the span over several blocks (flash-decoding, with
// the same two-level merge across blocks) is the first thing to add.
//
// Built by ray_tpu_torch/ops/_build.py with nvcc for sm_90a into a shared
// library with a plain C entry, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void bf16x8_to_float(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);              // low half: element 2i
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high half: 2i+1
  }
}

// fp32 -> nearest bf16 (ties to even) -> fp32, for finite x
__device__ __forceinline__ float round_to_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// 2^(m - m_new), exact, for integer shifts m <= m_new; 0 for m = -inf
__device__ __forceinline__ float pow2_shift(float m, float m_new) {
  return m == -INFINITY ? 0.f : ldexpf(1.f, (int)(m - m_new));
}

template <int HD, int G, int NW, int U>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const uint16_t* __restrict__ q,        // [B, nh, HD]
                    const uint16_t* __restrict__ pk,       // layer li: [NB, bs, kvh*HD]
                    const uint16_t* __restrict__ pv,
                    const int32_t* __restrict__ table,     // [B, W]
                    const int32_t* __restrict__ lengths,   // [B]
                    float* __restrict__ out,               // [B, nh*HD]
                    int W, int bs, float scale_log2) {
  constexpr int LPT = HD / 8;      // lanes per token
  constexpr int TPW = 32 / LPT;    // tokens a warp reads at once
  constexpr int NSLOT = NW * TPW;  // tokens the block reads at once
  constexpr int NT = NW * 32;
  constexpr unsigned kFull = 0xffffffffu;

  __shared__ float s_m[NW][G];
  __shared__ float s_l[NW][G];
  __shared__ float s_acc[NW][G][HD];

  const int kvh = gridDim.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nh = kvh * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPT;  // token slot inside the warp
  const int dl = lane % LPT;   // this lane's dims: [dl*8, dl*8 + 8)
  const int64_t kvd = (int64_t)kvh * HD;
  const int32_t* trow = table + (int64_t)b * W;

  // the span is lengths + 1; like the TPU kernel, never past the table
  const int nvalid = min(lengths[b] + 1, W * bs);

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((int64_t)b * nh + h * G + g) * HD + dl * 8);
    bf16x8_to_float(raw, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale_log2;  // scores in log2 units
  }

  // this warp's online-softmax state over its tokens; m is warp-uniform,
  // l and acc cover the lane's token slot (summed over slots at the end)
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
  const uint16_t* kh = pk + h * HD + dl * 8;
  const uint16_t* vh = pv + h * HD + dl * 8;
  // `base` is warp-uniform, so every lane reaches the shuffles below, and
  // token `base` itself is live: each chunk's max is finite
  for (int base = warp * TPW; base < nvalid; base += NSLOT * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * NSLOT + sub;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (t < nvalid) {
        const int64_t row = ((int64_t)__ldg(trow + t / bs) * bs + t % bs) * kvd;
        kr[u] = *reinterpret_cast<const uint4*>(kh + row);
        vr[u] = *reinterpret_cast<const uint4*>(vh + row);
      }
    }
    float s[U][G], cmax[G];
#pragma unroll
    for (int g = 0; g < G; ++g) cmax[g] = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = base + u * NSLOT + sub < nvalid;
      float kf[8];
      bf16x8_to_float(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qf[g][i], kf[i], d);
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
        s[u][g] = live ? d : -INFINITY;
        cmax[g] = fmaxf(cmax[g], s[u][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) {
        cmax[g] = fmaxf(cmax[g], __shfl_xor_sync(kFull, cmax[g], o));
      }
      const float m_new = fmaxf(m[g], ceilf(cmax[g]));
      const float corr = pow2_shift(m[g], m_new);  // 0 on the first chunk
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      bf16x8_to_float(vr[u], vf);  // zeros for a dead slot: p is 0 there
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = exp2f(s[u][g] - m[g]);
        l[g] += p;
        const float pb = round_to_bf16(p);  // the TPU kernel's p.astype(v)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pb, vf[i], acc[g][i]);
      }
    }
  }

  // sum the warp's token slots (lanes dl, dl+LPT, ... hold the same dims),
  // then merge the warps in a fixed order
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(kFull, acc[g][i], o);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s_acc[warp][g][dl * 8 + i] = acc[g][i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += NT) {
    const int g = e / HD;
    const int d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lt = 0.f, o = 0.f;
    if (mx != -INFINITY) {  // an empty span (lengths < 0) gives 0
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = pow2_shift(s_m[w][g], mx);  // 0: a warp with no tokens
        lt = fmaf(s_l[w][g], c, lt);
        o = fmaf(s_acc[w][g][d], c, o);
      }
      o /= lt;
    }
    out[((int64_t)b * nh + h * G + g) * HD + d] = o;
  }
}

template <int HD, int G>
cudaError_t launch(const uint16_t* q, const uint16_t* pk, const uint16_t* pv,
                   const int32_t* table, const int32_t* lengths, float* out,
                   int B, int kvh, int W, int bs, cudaStream_t stream) {
  constexpr int NW = 8;
  constexpr int U = G >= 8 ? 2 : 4;  // K and V loads in flight per thread
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  paged_decode_kernel<HD, G, NW, U><<<dim3(kvh, B), NW * 32, 0, stream>>>(
      q, pk, pv, table, lengths, out, W, bs, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_group(int group, const uint16_t* q, const uint16_t* pk,
                           const uint16_t* pv, const int32_t* table,
                           const int32_t* lengths, float* out, int B, int kvh, int W,
                           int bs, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<HD, 1>(q, pk, pv, table, lengths, out, B, kvh, W, bs, stream);
    case 2: return launch<HD, 2>(q, pk, pv, table, lengths, out, B, kvh, W, bs, stream);
    case 4: return launch<HD, 4>(q, pk, pv, table, lengths, out, B, kvh, W, bs, stream);
    case 8: return launch<HD, 8>(q, pk, pv, table, lengths, out, B, kvh, W, bs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, nh, hd] bf16; pk/pv [L, NB, bs, kvh*hd] bf16 with layer_offset the
// element offset of layer li (64-bit: a full-size pool holds ~2.7e8
// elements per tensor); table [B, W] and lengths [B] int32; out [B, nh*hd]
// fp32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_bf16(const void* q, const void* pk, const void* pv,
                                           const void* table, const void* lengths,
                                           void* out, long long layer_offset, int B,
                                           int nh, int kvh, int hd, int W, int bs,
                                           void* stream) {
  if (B <= 0 || kvh <= 0 || nh % kvh != 0 || W <= 0 || bs <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint16_t* q16 = static_cast<const uint16_t*>(q);
  const uint16_t* pk16 = static_cast<const uint16_t*>(pk) + layer_offset;
  const uint16_t* pv16 = static_cast<const uint16_t*>(pv) + layer_offset;
  const int32_t* tab = static_cast<const int32_t*>(table);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = nh / kvh;
  switch (hd) {
    case 64:
      return (int)dispatch_group<64>(group, q16, pk16, pv16, tab, len, o, B, kvh, W, bs, st);
    case 128:
      return (int)dispatch_group<128>(group, q16, pk16, pv16, tab, len, o, B, kvh, W, bs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
