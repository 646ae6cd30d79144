// What the wgmma flash kernels share, whatever their head_dim
// (flash_attention.cu at 128, flash_attention_d256.cu at 256): the
// softmax's power-of-two shifts and quad reductions, the accumulator
// stores, the delta pass, and on the host the tensor maps and the
// shared-memory opt-in.  Header only; each kernel source that includes it
// compiles it anew.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// A 64 x (N / 2) accumulator (N registers) -> bf16 pairs in global memory
// (row stride LD) at `out`, the thread's first row: its two rows, columns
// 8j + 2t, divided by div_a and div_b (true division, as the plain
// version's O / l; a divisor of 1 leaves the sums exact)
template <int N, int LD>
__device__ __forceinline__ void store_rows(uint16_t* out, const float (&acc)[N], int t,
                                           float div_a, float div_b) {
  uint16_t* pa = out + 2 * t;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    *reinterpret_cast<uint32_t*>(pa + 8 * j) =
        pack_bf16(acc[4 * j] / div_a, acc[4 * j + 1] / div_a);
    *reinterpret_cast<uint32_t*>(pa + 8 * LD + 8 * j) =
        pack_bf16(acc[4 * j + 2] / div_b, acc[4 * j + 3] / div_b);
  }
}

// delta[r] = sum_d dO[r, d] * O[r, d] in fp32 over rows of D columns; D / 8
// threads per row, 16 bytes of each input per thread, 256 threads a block
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                       float* __restrict__ delta) {
  constexpr int P = D / 8;  // threads per row: 16 or 32, inside one warp
  const int64_t row = (int64_t)blockIdx.x * (256 / P) + threadIdx.x / P;
  const int part = threadIdx.x % P;
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
  for (int off = P / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0) delta[row] = s;
}

// ------------------------------------------------------------------- host
// tensor map over a contiguous [rows x D] bf16 array: boxes of box_rows x
// 64 columns, 128-byte swizzle (what the kernels' descriptors read)
template <int D>
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

// the one head_dim a source is built for; S a multiple of the 128-row tiles
inline bool bad_shape(int bhq, int bhkv, int S, int d, int built) {
  return bhq <= 0 || bhkv <= 0 || bhq % bhkv != 0 || S <= 0 || S % 128 != 0 || d != built;
}

}  // namespace flash

#define RETURN_IF_ERROR(x)                  \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)
