"""Times versions of an fp32 FFMA kernel family in turns on one card.

Each SOURCE is a version of the KERNEL family's CUDA file (this
checkout's, another checkout's, an edited copy) with the same C entries:

- ``gmm`` (the default), ``ray_tpu_torch/ops/csrc/grouped_matmul_ffma.cu``:
  at chip_smoke.py phase 9's fp32 shapes (Mixtral-8x7B's widths, 16,384
  rows of a real routing over 8 experts) each gmm and tgmm variant of the
  MoE step, ``torch._grouped_mm`` beside it, CUDA events (median of 5);
- ``flash_fwd``, ``ray_tpu_torch/ops/csrc/flash_attention_ffma.cu``'s
  forward: at phase 6's shape ([8, 2048], 16 q over 8 kv heads, causal)
  at head_dim 128 and 256, CUDA events (median of 10).

Each source is built with the repo's nvcc flags into
``ray_tpu_torch/_build/``, its ptxas registers and spills and its SASS
counts printed, then run in a fresh process per round under a timeout, in
the order given and then reversed; on a source's first run each output is
held to its plain version and a repeat to the same bits.  The SM clock
and power are sampled by nvidia-smi every 100 ms beside.

    python3 gmm_ab.py [--kernel gmm|flash_fwd] [--rounds N] NAME=SOURCE.cu ...
    python3 gmm_ab.py --peak

``--peak`` times a loop of register-only FFMAs (the product loop's 8 x 16
or 8 x 8 outputs a thread, no memory traffic) on every SM: the FFMA rate a
kernel of that shape can reach on this card.  Imports torch and
ray_tpu_torch only.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.ops import grouped_matmul as gm  # noqa: E402

PEAK_SOURCE = r'''
#include <cuda_runtime.h>
template <int T, int R, int C>
__global__ void __launch_bounds__(T, 1) probe(float* out, const float* in, int iters) {
  float acc[R][C], a[R], b[C];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = in[(threadIdx.x + i) & 63];
#pragma unroll
  for (int j = 0; j < C; ++j) b[j] = in[(threadIdx.x * 3 + j) & 63];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] += 1e-7f;  // one FADD a row a step
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s += acc[i][j];
  out[blockIdx.x * T + threadIdx.x] = s;
}
extern "C" int run(int which, float* out, const float* in, int blocks, int iters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 0) probe<256, 8, 16><<<blocks, 256, 0, st>>>(out, in, iters);
  if (which == 1) probe<256, 8, 8><<<blocks, 256, 0, st>>>(out, in, iters);
  if (which == 2) probe<512, 8, 8><<<blocks, 512, 0, st>>>(out, in, iters);
  return (int)cudaGetLastError();
}
'''
PEAK_SHAPES = ((256, 8, 16), (256, 8, 8), (512, 8, 8))  # threads, rows, columns


def _nvcc(source: str, name: str) -> str:
    """Build ``source`` into ``_build/<name>.so``; print ptxas's lines."""
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    so = os.path.join(_build._BUILD_DIR, f"{name}.so")
    p = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", so, source],
                       capture_output=True, text=True)
    for line in (p.stdout + p.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line or "error" in line:
            print("   ", line.strip())
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {source}")
    return so


def _load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    lib.ray_tpu_torch_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bind_gmm(so: str):
    """(library, gmm entry, tgmm entry) as grouped_matmul._library binds them."""
    lib = _load(so)
    fg, ft = lib.grouped_matmul_gmm_fp32, lib.grouped_matmul_tgmm_fp32
    fg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    ft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fg.restype = ft.restype = ctypes.c_int
    return lib, fg, ft


def _bind_flash(so: str) -> ctypes.CDLL:
    """The library as flash_attention._ffma_library binds it."""
    lib = _load(so)
    lib.flash_ffma_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                   + [ctypes.c_float] + [ctypes.c_void_p])
    lib.flash_ffma_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.flash_ffma_fwd.restype = lib.flash_ffma_bwd.restype = ctypes.c_int
    return lib


def _sampler() -> subprocess.Popen:
    return subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)


def _report(smi: subprocess.Popen, res: dict) -> None:
    """Stop the sampler, add its SM clock and power to ``res``, print it."""
    smi.terminate()
    samples = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    if samples:
        res["sm MHz median"] = sorted(float(a) for a, _ in samples)[len(samples) // 2]
        res["W max"] = max(float(b) for _, b in samples)
    print("RESULT " + json.dumps(res), flush=True)


def child_gmm(name: str, so: str, check: bool) -> None:
    """One run of ``so`` at phase 9's fp32 shapes; prints a RESULT line."""
    from ray_tpu_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    gm._libs[torch.float32] = _bind_gmm(so)
    dev = torch.device("cuda")
    cfg = smoke.mixtral_config(moe)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 3)
    tokens, e, dims = 8192, cfg.n_experts, (cfg.dim, cfg.ffn_dim)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    router = torch.randn((cfg.dim, e), generator=gen, device=dev) * 0.02
    _, idx, _ = moe._router(cfg, randn(tokens, cfg.dim), {"router": router})
    routed = moe._sorted_order(idx.reshape(-1), e)[1][:e].contiguous()
    m = tokens * cfg.experts_per_token
    lhs = {0: randn(m, dims[0]), 1: randn(m, dims[1])}
    smi = _sampler()
    res = {"name": name, "sizes": routed.tolist()}

    def measure(op, label, run, plain, library, tol):
        if check:
            out = run()
            res[f"ratio {op} {label}"] = ((out - plain()).abs() / tol()).max().item()
            res[f"same bits {op} {label}"] = torch.equal(out, run())
            res[f"lib {op} {label}"] = smoke.time_ms(lambda i: library(), reps=5)
        res[f"{op} {label}"] = smoke.time_ms(lambda i: run(), reps=5)

    for label, ki, ni, trans, _ in smoke.GMM_VARIANTS:
        x, k, n = lhs[ki], dims[ki], dims[ni]
        rhs = randn(e, n, k) if trans else randn(e, k, n)
        library, _ = smoke._library_gmm(gm, x, rhs, routed, trans)
        measure("gmm", label, lambda: gm.gmm(x, rhs, routed, transpose_rhs=trans),
                lambda: gm.gmm_reference(x, rhs, routed, transpose_rhs=trans), library,
                lambda: gm.kernel_tolerance("gmm", x, rhs, routed, transpose_rhs=trans))
        del rhs, library
        torch.cuda.empty_cache()
    for label, ki, ni, _ in smoke.TGMM_VARIANTS:
        x, grad = lhs[ki], randn(m, dims[ni])
        library, _ = smoke._library_tgmm(gm, x.t(), grad, routed)
        measure("tgmm", label, lambda: gm.tgmm(x.t(), grad, routed),
                lambda: gm.tgmm_reference(x.t(), grad, routed), library,
                lambda: gm.kernel_tolerance("tgmm", x.t(), grad, routed))
        del grad, library
        torch.cuda.empty_cache()
    for op, variants, col in (("gmm", smoke.GMM_VARIANTS, 4), ("tgmm", smoke.TGMM_VARIANTS, 3)):
        w = {v[0]: v[col] for v in variants}
        for pre in ("", "lib ") if check else ("",):
            res[f"{pre}{op} weighted"] = (sum(n * res[f"{pre}{op} {k}"] for k, n in w.items())
                                          / sum(w.values()))
    _report(smi, res)


def child_flash_fwd(name: str, so: str, check: bool) -> None:
    """One run of ``so``'s fp32 forward at phase 6's shape, causal, at
    head_dim 128 and 256; prints a RESULT line."""
    fa._ffma_lib = _bind_flash(so)
    dev = torch.device("cuda")
    smi = _sampler()
    res = {"name": name}
    for (dtype, d), inst in fa.INSTANTIATIONS.items():
        if dtype != torch.float32:
            continue
        gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 7)
        q3, k3, v3, _ = smoke._flash_inputs(dev, gen, 8, 2048, 16, 8, d, dtype)
        kw = dict(scale=d ** -0.5, causal=True, n_rep=2)

        def run(_):
            return fa.flash_attention_fwd(q3, k3, v3, **kw)

        if check:
            o, lse = run(0)
            ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
            tol = fa.kernel_tolerance(q3, k3, v3, ro, rlse, torch.zeros_like(q3), **kw)
            res[f"{inst} ratio"] = max(((o - ro).abs() / tol["o"]).max().item(),
                                       ((lse - rlse).abs() / tol["lse"]).max().item())
            res[f"{inst} same bits"] = torch.equal(o, run(0)[0])
            del o, lse, ro, rlse, tol
            torch.cuda.empty_cache()
        res[f"{inst} ms"] = smoke.time_ms(run, reps=10)
    _report(smi, res)


# kernel family: (child, SASS kernels {mangled-name part: label}, SASS ops)
KERNELS = {
    "gmm": (child_gmm, smoke.GMM_FFMA_KERNELS, smoke.GMM_FFMA_SASS_OPS),
    "flash_fwd": (child_flash_fwd, {k: v for k, v in smoke.FFMA_FLASH_KERNELS.items()
                                    if "fwd" in k}, smoke.FFMA_SASS_OPS),
}


def peak() -> None:
    """The FFMA rate of a register-only product loop on every SM."""
    src = os.path.join(_build._BUILD_DIR, "ffma_peak.cu")
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    with open(src, "w") as f:
        f.write(PEAK_SOURCE)
    lib = ctypes.CDLL(_nvcc(src, "ffma_peak"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    inp = torch.rand(64, device="cuda")
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    stream = torch.cuda.current_stream().cuda_stream
    for which, (t, r, c) in enumerate(PEAK_SHAPES):
        out = torch.empty(blocks * t, device="cuda")
        lib.run(which, out.data_ptr(), inp.data_ptr(), blocks, 10, stream)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.run(which, out.data_ptr(), inp.data_ptr(), blocks, 2000, stream)
        end.record()
        torch.cuda.synchronize()
        flops = 2.0 * blocks * t * r * c * 16 * 2000
        rate = flops / start.elapsed_time(end) / 1e9
        print(f"ffma peak: {t} threads, {r} x {c} a thread, {blocks} blocks: {rate:.1f} "
              f"TFLOP/s, {100 * rate * 1e12 / smoke.FP32_FLOPS_PER_S:.1f}% of "
              f"{smoke.FP32_FLOPS_PER_S / 1e12:.0f}", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        KERNELS[sys.argv[2]][0](sys.argv[3], sys.argv[4], sys.argv[5] == "1")
        return 0
    if not torch.cuda.is_available():
        print("gmm_ab: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.card(), flush=True)
    if sys.argv[1:] == ["--peak"]:
        peak()
        return 0
    args, rounds, kernel = sys.argv[1:], 2, "gmm"
    while args[:1] in (["--rounds"], ["--kernel"]):
        if args[0] == "--rounds":
            rounds = int(args[1])
        else:
            kernel = args[1]
        args = args[2:]
    if not args or kernel not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    _, sass_kernels, sass_ops = KERNELS[kernel]
    built = {}
    for name, source in (a.split("=", 1) for a in args):
        print(f"--- {name}: {source}", flush=True)
        built[name] = _nvcc(os.path.abspath(source), f"{kernel}_ab_{name}")
        counts = smoke.sass_counts(built[name], tuple(sass_kernels), sass_ops)
        for key, label in sass_kernels.items():
            print(f"    sass {label}: {counts.get(key)}", flush=True)
    order, seen = list(built), set()
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            try:
                p = subprocess.run([sys.executable, __file__, "--child", kernel, name, built[name],
                                    "0" if name in seen else "1"],
                                   capture_output=True, text=True, timeout=300, cwd=HERE)
                out = p.stdout + p.stderr
            except subprocess.TimeoutExpired as exc:
                out = f"timed out: {exc}"
            seen.add(name)
            lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
            print(f"round {r} {name} ({time.perf_counter() - t0:.1f} s): "
                  + (lines[-1][7:] if lines else "FAILED\n" + out[-3000:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
