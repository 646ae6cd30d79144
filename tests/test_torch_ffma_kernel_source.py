"""The fp32 flash kernels' CUDA source, run on the CPU.

The kernels of ``ray_tpu_torch/ops/csrc/flash_attention_ffma.cu`` (the
forward ``ffma_fwd_kernel``; the backward's ``ffma_delta_kernel``,
``ffma_bwd_kernel`` for dK/dV and dQ, ``ffma_group_sum_kernel``) are
compiled with the host's C++ compiler against a stand-in for the CUDA
features they use: a block runs as 256 threads with a barrier for
``__syncthreads``; a warp's ``__shfl_xor_sync`` goes through a 32-thread
barrier and an exchange buffer, and ``__syncwarp`` through that barrier;
``cp.async`` copies land either when issued or when the wait that retires
their group runs, so a read before its wait, or a stage overwritten while
it is read, shows; shared memory starts as NaN.  At tiny shapes O and the
LSE, and the gradients, must stay within ``kernel_tolerance`` of the plain
versions, and a dropped key must break it.  Skips where the host has no
C++20 compiler.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.timeout(240)

_PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <barrier>
#include <deque>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 threadIdx, blockIdx;
dim3 gridDim;
thread_local float* g_sm;
std::barrier<>* g_block;
inline void __syncthreads() { g_block->arrive_and_wait(); }
struct Warp { std::barrier<>* bar; float buf[32]; };
thread_local Warp* g_warp;
inline void __syncwarp() { g_warp->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int lane = threadIdx.x & 31;
  g_warp->buf[lane] = v;
  g_warp->bar->arrive_and_wait();
  const float r = g_warp->buf[lane ^ mask];
  g_warp->bar->arrive_and_wait();
  return r;
}
bool g_eager = false;
thread_local std::deque<std::vector<std::pair<float*, const float*>>> g_groups;
thread_local std::vector<std::pair<float*, const float*>> g_open;
inline void cp_async16(float* dst, const float* src) {
  if (((uintptr_t)dst | (uintptr_t)src) & 15) abort();  // 16-byte aligned only
  if (g_eager) memcpy(dst, src, 16); else g_open.push_back({dst, src});
}
inline void cp_async_commit() { g_groups.push_back(g_open); g_open.clear(); }
inline void cp_async_wait_all() {
  for (auto& group : g_groups)
    for (auto& c : group) memcpy(c.first, c.second, 16);
  g_groups.clear();
}
'''

_HARNESS = r'''
template <typename Body>
void launch(dim3 grid, size_t smem_bytes, Body body) {
  gridDim = grid;
  std::vector<float> smem(smem_bytes / 4 + 4);
  float* base = (float*)(((uintptr_t)smem.data() + 15) & ~(uintptr_t)15);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      for (auto& x : smem) x = NAN;
      std::barrier<> block(kThreads);
      g_block = &block;
      std::vector<Warp> warps(kThreads / 32);
      for (auto& w : warps) w.bar = new std::barrier<>(32);
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < (unsigned)kThreads; ++t)
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          g_sm = base;
          g_warp = &warps[t / 32];
          g_groups.clear();
          g_open.clear();
          body();
          if (!g_groups.empty() || !g_open.empty()) abort();  // copies in flight at exit
        });
      for (auto& t : threads) t.join();
      for (auto& w : warps) delete w.bar;
    }
}

template <int D>
void fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bhq, int bhkv,
         int S, int causal, float scale_log2) {
  launch(dim3(bhq, S / Fwd<D>::BQ), Fwd<D>::kFloats * 4, [&] {
    ffma_fwd_kernel<D>(q, k, v, o, lse, S, bhq / bhkv, causal, scale_log2);
  });
}

extern "C" int run_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       int bhq, int bhkv, int S, int D, int causal, float scale_log2, int eager) {
  g_eager = eager;
  if (D == 128) fwd<128>(q, k, v, o, lse, bhq, bhkv, S, causal, scale_log2);
  else if (D == 256) fwd<256>(q, k, v, o, lse, bhq, bhkv, S, causal, scale_log2);
  else return 1;
  return 0;
}

template <int D>
void bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
         const float* lse, float* d, float* dq, float* dk, float* dv, int bhq, int bhkv, int S,
         int causal, float scale, float scale_log2) {
  const int64_t rows = (int64_t)bhq * S;
  const int n_rep = bhq / bhkv;
  for (int64_t r = 0; r < rows; ++r) {
    float x = 0.f;
    for (int i = 0; i < D; ++i) x = fmaf(dout[r * D + i], o[r * D + i], x);
    d[r] = x;
  }
  float* part_k = n_rep > 1 ? d + rows : dk;
  float* part_v = n_rep > 1 ? part_k + rows * D : dv;
  const dim3 grid(bhq, S / Bwd<D>::BM);
  const size_t smem = Bwd<D>::kFloats * 4;
  launch(grid, smem, [&] {
    ffma_bwd_kernel<D, true>(q, k, v, dout, lse, d, part_k, part_v, S, n_rep, causal, scale,
                             scale_log2);
  });
  if (n_rep > 1) {
    const int64_t head4 = (int64_t)S * D / 4, n4 = (int64_t)bhkv * head4;
    gridDim = dim3(3, 2);
    for (unsigned y = 0; y < 2; ++y)
      for (unsigned x = 0; x < 3; ++x)
        for (unsigned t = 0; t < (unsigned)kThreads; ++t) {
          blockIdx = dim3(x, y);
          threadIdx = dim3(t);
          ffma_group_sum_kernel((const float4*)part_k, (const float4*)part_v, (float4*)dk,
                                (float4*)dv, head4, n4, n_rep);
        }
  }
  launch(grid, smem, [&] {
    ffma_bwd_kernel<D, false>(q, k, v, dout, lse, d, dq, nullptr, S, n_rep, causal, scale,
                              scale_log2);
  });
}

extern "C" int run_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* d, float* dq, float* dk,
                       float* dv, int bhq, int bhkv, int S, int D, int causal, float scale,
                       float scale_log2, int eager) {
  g_eager = eager;
  if (D == 128) bwd<128>(q, k, v, o, dout, lse, d, dq, dk, dv, bhq, bhkv, S, causal, scale, scale_log2);
  else if (D == 256) bwd<256>(q, k, v, o, dout, lse, d, dq, dk, dv, bhq, bhkv, S, causal, scale, scale_log2);
  else return 1;
  return 0;
}
'''


def _cpu_source() -> str:
    """The kernels' part of the CUDA source, with the stand-ins."""
    with open(f"{_build._CSRC}/flash_attention_ffma.cu") as f:
        src = f.read()
    body = src[src.index("template <int D>\nstruct Bwd"):
               src.index("// ---------------------------------------------"
                         "---------------------- host")]
    # the inline-PTX copy helpers give way to the stand-in's
    body = (body[:body.index("__device__ __forceinline__ void cp_async16")]
            + body[body.index("// rows [0, rows) of a"):])
    body = body.replace("extern __shared__ __align__(16) float sm[];",
                        "float* sm = g_sm;")
    consts = "\n".join(re.search(p, src).group(0) for p in (
        r"constexpr int kThreads = \d+;", r"constexpr int BK = \d+;",
        r"constexpr int kBN = \d+;", r"constexpr float kLog2e = [\d.]+f;",
        r"constexpr float kLn2 = [\d.]+f;"))
    return _PRELUDE + consts + "\n" + body + _HARNESS


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("ffma_cpu")
    (d / "bwd.cpp").write_text(_cpu_source())
    built = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
         str(d / "bwd.so"), str(d / "bwd.cpp")], capture_output=True, text=True)
    if built.returncode and "c++20" in built.stderr:
        pytest.skip("the host's C++ compiler takes no C++20")
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "bwd.so"))
    lib.run_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                            + [ctypes.c_float] * 2 + [ctypes.c_int])
    lib.run_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                            + [ctypes.c_float] + [ctypes.c_int])
    return lib


def _run(lib, d, s, group, causal, eager, cut=None, hkv=1, seed=0):
    """(ratios to the tolerance over all rows, at the last row/key)."""
    rng = np.random.default_rng(seed)
    bhq = hkv * group
    q3, do = (torch.from_numpy(rng.standard_normal((bhq, s, d)).astype(np.float32))
              for _ in range(2))
    k3, v3 = (torch.from_numpy(rng.standard_normal((hkv, s, d)).astype(np.float32))
              for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal, n_rep=group)
    o, lse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    want = fa.flash_attention_bwd_reference(q3, k3, v3, o, lse, do, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, o, lse, do, **kw)
    ins = {"q": q3, "k": k3, "v": v3, "do": do}
    if cut:
        ins[cut] = ins[cut].clone()
        ins[cut][:, -1] = 0
    scratch = torch.full((bhq * s + (2 * bhq * s * d if group > 1 else 0),),
                         float("nan"))
    got = [torch.full_like(t, float("nan")) for t in (q3, k3, v3)]
    lib.run_bwd(ins["q"].data_ptr(), ins["k"].data_ptr(), ins["v"].data_ptr(),
                o.data_ptr(), ins["do"].data_ptr(), lse.data_ptr(),
                scratch.data_ptr(), *(g.data_ptr() for g in got), bhq, hkv, s,
                d, int(causal), kw["scale"], fa._scale_log2(kw["scale"]),
                int(eager))
    names = ("dq", "dk", "dv")
    full = {n: ((g - w).abs() / tol[n]).max().item()
            for n, g, w in zip(names, got, want)}
    last = {n: ((g[:, -1] - w[:, -1]).abs() / tol[n][:, -1]).max().item()
            for n, g, w in zip(names, got, want)}
    return full, last


@pytest.mark.parametrize("d, s, group, causal, eager", [
    (128, 128, 2, True, False), (128, 256, 1, False, True),
    (256, 128, 2, False, True), (256, 128, 1, True, False)])
def test_backward_source_within_tolerance(kernels, d, s, group, causal, eager):
    full, _ = _run(kernels, d, s, group, causal, eager)
    assert max(full.values()) <= 1, full


@pytest.mark.parametrize("d", [128, 256])
def test_backward_source_breaks_tolerance_without_the_last_key(kernels, d):
    # the last key feeds only the last query row, and only the last query
    # row feeds the last key
    _, last = _run(kernels, d, 128, 2, True, False, cut="k")
    assert last["dq"] > 1, last
    _, last = _run(kernels, d, 128, 2, True, False, cut="do")
    assert last["dk"] > 1 and last["dv"] > 1, last


def _run_fwd(lib, d, s, group, causal, eager, cut=False, hkv=1, seed=0):
    """(ratios of O and the LSE to their tolerance over all rows, O's at the
    last row); ``cut``: the last key's V zeroed in the kernel's input."""
    rng = np.random.default_rng(seed)
    bhq = hkv * group
    q3 = torch.from_numpy(rng.standard_normal((bhq, s, d)).astype(np.float32))
    k3, v3 = (torch.from_numpy(rng.standard_normal((hkv, s, d)).astype(np.float32))
              for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal, n_rep=group)
    want_o, want_lse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
    tol = fa.kernel_tolerance(q3, k3, v3, want_o, want_lse, torch.zeros_like(q3),
                              **kw)
    v_in = v3.clone()
    if cut:
        v_in[:, -1] = 0
    o = torch.full_like(q3, float("nan"))
    lse = torch.full((bhq, s), float("nan"))
    lib.run_fwd(q3.data_ptr(), k3.data_ptr(), v_in.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bhq, hkv, s, d, int(causal),
                fa._scale_log2(kw["scale"]), int(eager))
    full = {"o": ((o - want_o).abs() / tol["o"]).max().item(),
            "lse": ((lse - want_lse).abs() / tol["lse"]).max().item()}
    last = ((o[:, -1] - want_o[:, -1]).abs() / tol["o"][:, -1]).max().item()
    return full, last


@pytest.mark.parametrize("d, s, group, causal, eager", [
    (128, 128, 2, True, False), (128, 256, 1, False, True),
    (128, 256, 2, True, True), (256, 128, 1, True, True),
    (256, 256, 2, False, False), (256, 256, 1, True, False)])
def test_forward_source_within_tolerance(kernels, d, s, group, causal, eager):
    full, _ = _run_fwd(kernels, d, s, group, causal, eager)
    assert max(full.values()) <= 1, full


@pytest.mark.parametrize("d", [128, 256])
def test_forward_source_breaks_tolerance_without_the_last_key(kernels, d):
    # the last key feeds only the last query row
    _, last = _run_fwd(kernels, d, 128, 2, True, False, cut=True)
    assert last > 1, last
