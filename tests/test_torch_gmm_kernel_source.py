"""The fp32 grouped matmuls' CUDA source, run on the CPU.

The kernels of ``ray_tpu_torch/ops/csrc/grouped_matmul_ffma.cu``
(``gmm_ffma_kernel`` with and without ``transpose_rhs``,
``tgmm_ffma_kernel``) are compiled with the host's C++ compiler against a
stand-in for the CUDA features they use: a block runs as 256 threads with
a barrier for ``__syncthreads`` and its ``__shared__`` arrays shared among
them; ``cp.async`` copies (a source size of 0 fills zeros) land either
when issued or when the wait that retires their group runs, so a read
before its wait, or a stage overwritten while it is read, shows; shared
memory and the output start as NaN, so an element no block writes shows.
At small shapes (K and N tails inside a stage and a tile, groups that end
inside a tile, an empty group, rows past the last group) the results must
stay within ``kernel_tolerance`` of the plain versions; a row moved across
a group boundary (gmm) or left out of its group (tgmm) must break it, and
inf in the next group's rows must stay out of a tgmm group.  Skips where
the host has no C++20 compiler.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import grouped_matmul as gm

pytestmark = pytest.mark.timeout(240)

_PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <deque>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
#define __shared__ static
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
bool g_eager = false;
alignas(16) const float g_zero[4] = {0.f, 0.f, 0.f, 0.f};
thread_local std::deque<std::vector<std::pair<float*, const float*>>> g_groups;
thread_local std::vector<std::pair<float*, const float*>> g_open;
inline void cp_async16(float* dst, const float* src, bool valid) {
  if (((uintptr_t)dst | (uintptr_t)src) & 15) abort();  // 16-byte aligned only
  const float* from = valid ? src : g_zero;
  if (g_eager) memcpy(dst, from, 16); else g_open.push_back({dst, from});
}
inline void cp_async_commit() { g_groups.push_back(g_open); g_open.clear(); }
template <int N>
inline void cp_async_wait() {
  while ((int)g_groups.size() > N) {
    for (auto& c : g_groups.front()) memcpy(c.first, c.second, 16);
    g_groups.pop_front();
  }
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
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < (unsigned)kThreads; ++t)
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          g_sm = base;
          g_groups.clear();
          g_open.clear();
          body();
          if (!g_groups.empty() || !g_open.empty()) abort();  // copies in flight at exit
        });
      for (auto& t : threads) t.join();
    }
}

template <bool TRANS>
void gmm(const float* lhs, const float* rhs, const int* sizes, float* out, int M, int K, int N,
         int E) {
  const unsigned blocks = (unsigned)(((M + BM - 1) / BM + E) * ((N + BN - 1) / BN));
  launch(dim3(blocks), kGmmSmem<TRANS>,
         [&] { gmm_ffma_kernel<TRANS>(lhs, rhs, sizes, out, M, K, N, E); });
}

extern "C" int run_gmm(const float* lhs, const float* rhs, const int* sizes, float* out, int M,
                       int K, int N, int E, int transpose_rhs, int eager) {
  g_eager = eager;
  if (transpose_rhs) gmm<true>(lhs, rhs, sizes, out, M, K, N, E);
  else gmm<false>(lhs, rhs, sizes, out, M, K, N, E);
  return 0;
}

extern "C" int run_tgmm(const float* lhs, const float* grad, const int* sizes, float* out, int M,
                        int K, int N, int E, int eager) {
  g_eager = eager;
  const dim3 grid(((K + BM - 1) / BM) * ((N + BN - 1) / BN), E);
  launch(grid, kTgmmSmem,
         [&] { tgmm_ffma_kernel(lhs, grad, sizes, out, M, K, N, E); });
  return 0;
}
'''

_RULE = "// " + "-" * 64 + " "


def _cpu_source() -> str:
    """The kernels' part of the CUDA source, with the stand-ins."""
    with open(f"{_build._CSRC}/grouped_matmul_ffma.cu") as f:
        src = f.read()
    body = src[src.index("constexpr int kThreads"):src.index(_RULE + "host")]
    # the inline-PTX copy helpers give way to the stand-in's
    body = (body[:body.index(_RULE + "cp.async")]
            + body[body.index(_RULE + "common"):])
    body = body.replace("extern __shared__ __align__(16) float sm[];",
                        "float* sm = g_sm;")
    return _PRELUDE + body + _HARNESS


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("gmm_cpu")
    (d / "gmm.cpp").write_text(_cpu_source())
    built = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
         str(d / "gmm.so"), str(d / "gmm.cpp")], capture_output=True, text=True)
    if built.returncode and "c++20" in built.stderr:
        pytest.skip("the host's C++ compiler takes no C++20")
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "gmm.so"))
    lib.run_gmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    lib.run_tgmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    return lib


def _randn(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x)


def _gmm(lib, lhs, rhs, sizes, transpose_rhs, eager):
    m, k = lhs.shape
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.full((m, n), float("nan"))
    lib.run_gmm(lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
                out.data_ptr(), m, k, n, sizes.shape[0], int(transpose_rhs),
                int(eager))
    return out


def _tgmm(lib, lhs, grad, sizes, eager):
    m, k = lhs.shape
    n = grad.shape[1]
    out = torch.full((sizes.shape[0], k, n), float("nan"))
    lib.run_tgmm(lhs.data_ptr(), grad.data_ptr(), sizes.data_ptr(),
                 out.data_ptr(), m, k, n, sizes.shape[0], int(eager))
    return out


def _ratio(got, want, tol):
    return ((got - want).abs() / tol).max().item()


# (M, K, N, group sizes): K 72 ends inside a 16-deep stage and N 264 inside
# a 256-column tile; groups that end inside a 128-row tile; an empty group;
# rows past the last group; and sizes that sum past M (clamped)
CASES = [(300, 72, 264, [100, 150]),
         (520, 136, 200, [0, 7, 250, 3, 0, 140, 100, 0]),
         (200, 64, 72, [150, 0, 90])]


@pytest.mark.parametrize("m,k,n,sizes", CASES)
@pytest.mark.parametrize("transpose_rhs,eager", [(False, False), (True, True)])
def test_gmm_source_within_tolerance(kernels, m, k, n, sizes, transpose_rhs,
                                     eager):
    lhs = _randn((m, k), 0)
    rhs = _randn((len(sizes), n, k) if transpose_rhs else (len(sizes), k, n), 1)
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = _gmm(kernels, lhs, rhs, gs, transpose_rhs, eager)
    want = gm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert _ratio(got, want, tol) <= 1
    assert not got[min(sum(sizes), m):].any()  # rows past the last group


@pytest.mark.parametrize("m,k,n,sizes", CASES)
@pytest.mark.parametrize("eager", [False, True])
def test_tgmm_source_within_tolerance(kernels, m, k, n, sizes, eager):
    lhs, grad = _randn((m, k), 2), _randn((m, n), 3)
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = _tgmm(kernels, lhs, grad, gs, eager)
    want = gm.tgmm_reference(lhs.t(), grad, gs)
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    assert _ratio(got, want, tol) <= 1
    for g, (a, b) in enumerate(gm._spans(gs, m)):
        if a == b:  # a group without rows is written, as zeros
            assert not got[g].any()


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_source_breaks_tolerance_with_a_moved_row(kernels, transpose_rhs):
    # row 100, the first of group 1, computed with group 0's rhs
    m, k, n, sizes = CASES[0]
    lhs = _randn((m, k), 4)
    rhs = _randn((2, n, k) if transpose_rhs else (2, k, n), 5)
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = gm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    tol = gm.kernel_tolerance("gmm", lhs, rhs, gs, transpose_rhs=transpose_rhs)
    cut = _gmm(kernels, lhs, rhs, torch.tensor([101, 149], dtype=torch.int32),
               transpose_rhs, False)
    assert _ratio(cut[100], want[100], tol[100]) > 1
    keep = torch.ones(m, dtype=torch.bool)
    keep[100] = False
    assert _ratio(cut[keep], want[keep], tol[keep]) <= 1


def test_tgmm_source_breaks_tolerance_without_a_row_and_keeps_inf_out(kernels):
    m, k, n, sizes = CASES[0]
    lhs, grad = _randn((m, k), 6), _randn((m, n), 7)
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = gm.tgmm_reference(lhs.t(), grad, gs)
    tol = gm.kernel_tolerance("tgmm", lhs.t(), grad, gs)
    # the last row of group 0 left out of its sum
    cut_grad = grad.clone()
    cut_grad[99] = 0
    cut = _tgmm(kernels, lhs, cut_grad, gs, False)
    assert _ratio(cut[0], want[0], tol[0]) > 1
    assert _ratio(cut[1], want[1], tol[1]) <= 1
    # group 0 (rows 0..99) ends inside a 16-row stage whose tail holds
    # group 1's rows, inf in both operands: zero-filled, they stay out
    lhs[100:250] = float("inf")
    grad[100:250] = float("inf")
    got = _tgmm(kernels, lhs, grad, gs, False)
    assert torch.isfinite(got[0]).all()
    assert _ratio(got[0], want[0], tol[0]) <= 1
